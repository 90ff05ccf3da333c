"""Durable incremental rollups: the fleet telemetry plane's fold layer
(``hfrep_tpu/obs/rollup.py``).

A week-long soak (N serve replicas, actor pods, scenario daemons)
produces JSONL event streams that grow without bound and that the
post-mortem readers (``report``/``gate``/``explain``) were never meant
to re-parse continuously.  This module adds the missing tier between
the append-only streams and those readers:

* **Incremental ingest** (:func:`ingest`): an offset-cursor consumer in
  the ``_StreamFollower`` discipline — only newline-complete lines are
  ever consumed, so a torn tail is simply "not yet written" — that
  folds events into **time-bucketed rollup segments**: counters summed
  (running total kept, per-bucket increments from the ``delta`` attr),
  gauges folded last-wins with min/max envelopes, histograms merged
  through the same sparse log-bucket accumulator the in-process
  :class:`hfrep_tpu_torch.obs.Histogram` uses.  The whole rollup state —
  segments AND cursors — is ONE atomically-replaced JSON document, so
  a SIGKILLed consumer either sees the pre-fold state (and re-folds the
  identical bytes) or the post-fold state (and skips them): exactly
  once, bit-identical on resume, idempotent on re-ingest.

* **Retention** (:func:`compact`, :func:`rotate_live`): an oversized
  live stream rotates aside to ``rollup/chunk-<n>.jsonl``; compaction
  folds each whole chunk into the rollup segments plus a *reader seed*
  (``rollup/compact.json``) and pins the low-volume evidence records
  verbatim (``rollup/pinned-<n>.jsonl`` — every ``event``/``memory``
  record, ``block``/``compile:*``/warmup/traced spans), then deletes
  the chunk.  ``report``/``gate``/``explain``/``--trace`` reconstruct
  their verdicts from seed + pinned + live and stay byte-equal to the
  raw-stream results (``tests/test_torch_rollup.py``); high-volume
  metric samples survive only as aggregates.  Compaction is driven by
  a per-chunk ledger inside ``compact.json``: fold → pin → publish
  ledger → unlink, each step idempotent, so a SIGKILL anywhere leaves
  a state the next run completes without losing or double-counting a
  single record.

Everything here is stdlib-only (no torch import): the fleet watcher and
the SLO evaluator run on hosts that never touch an accelerator.  The
one fault-injection surface is ``io_fail@rollup_publish`` — every
atomic publish (state, seed, pinned) crosses it, so a fault plan can
kill or EIO the consumer mid-segment and mid-compaction.

The rollup state, the reader seed and the pinned files are the JAX
module's byte for byte, so either package reads the other's compacted
run dir.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from hfrep_tpu_torch.obs import _HIST_BUCKETS_PER_DECADE
from hfrep_tpu_torch.obs.report import EVENTS_NAME, parse_event

ROLLUP_DIR = "rollup"
STATE_NAME = "state.json"
COMPACT_NAME = "compact.json"
CHUNK_RE = re.compile(r"^chunk-(\d+)\.jsonl$")
PINNED_RE = re.compile(r"^pinned-(\d+)\.jsonl$")

STATE_VERSION = 1
DEFAULT_BUCKET_SECS = 60.0
#: default live-stream rotation threshold (``obs compact`` and the
#: writer-side ``Obs`` rotation share it)
DEFAULT_ROTATE_BYTES = 1 << 20

#: cursor identity: sha256 over the first ``min(_SIG_BYTES, offset)``
#: bytes at cursor-publish time.  Streams are append-only, so the head
#: window is immutable — the signature survives a rotation RENAME and
#: lets a cursor follow its stream to the new name instead of
#: re-consuming (double-count) or resetting (drop).
_SIG_BYTES = 4096

#: restart timestamps kept per run for storm detection (bounded)
_RESTART_TIMES_KEPT = 64


# ----------------------------------------------------------- publication
def _io_fault_hook():
    """The ``rollup_publish`` injection point (None when no plan armed)."""
    from hfrep_tpu_torch.resilience import io_hook
    return io_hook("rollup_publish")


def _publish_bytes(path: Path, data: bytes) -> None:
    """Atomic durable publish: tmp + fsync + rename, behind the
    ``rollup_publish`` fault site."""
    path.parent.mkdir(parents=True, exist_ok=True)
    hook = _io_fault_hook()
    if hook is not None:
        hook()
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _canonical(obj) -> bytes:
    # NOT sort_keys: key order is first-seen fold order, which the
    # reader seed needs (gauge/counter dict order must reproduce the
    # raw stream's first-seen order for byte-equal verdicts)
    return (json.dumps(obj, separators=(",", ":")) + "\n").encode()


def _load_json(path: Path) -> Optional[dict]:
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None


# ------------------------------------------------------------ fold state
def _new_state(bucket_secs: float) -> dict:
    return {"v": STATE_VERSION, "bucket_secs": float(bucket_secs),
            "cursors": {}, "buckets": {}, "facts": _new_facts()}


def _new_facts() -> dict:
    return {"serve_drain": None,
            "breaker": {"opens": 0, "closes": 0, "state": "closed",
                        "last_t": None, "last_reason": None},
            "restarts": {"n": 0, "t": [], "actors": {}},
            "run_end": False}


def _new_bucket() -> dict:
    return {"counts": {}, "events": {}, "counters": {}, "gauges": {},
            "hists": {}, "spans": {}}


def new_hist() -> dict:
    return {"n": 0, "sum": 0.0, "min": None, "max": None,
            "zeros": 0, "negs": 0, "counts": {}}


def hist_observe(h: dict, v) -> None:
    """One sample into a serialized log-bucket accumulator — the same
    bucket math as :class:`hfrep_tpu_torch.obs.Histogram` (keys stringified
    for JSON)."""
    try:
        v = float(v)
    except (TypeError, ValueError):
        return
    h["n"] += 1
    h["sum"] += v
    if h["min"] is None or v < h["min"]:
        h["min"] = v
    if h["max"] is None or v > h["max"]:
        h["max"] = v
    if v > 0.0 and math.isfinite(v):
        idx = str(math.floor(math.log10(v) * _HIST_BUCKETS_PER_DECADE))
        h["counts"][idx] = h["counts"].get(idx, 0) + 1
    elif v == 0.0:
        h["zeros"] += 1
    else:
        h["negs"] += 1


def hist_merge(dst: dict, src: dict) -> dict:
    """Fold ``src`` into ``dst`` (both serialized accumulators)."""
    dst["n"] += src["n"]
    dst["sum"] += src["sum"]
    for bound in ("min", "max"):
        v = src.get(bound)
        if v is not None:
            cur = dst.get(bound)
            keep = (cur is None or (v < cur if bound == "min" else v > cur))
            if keep:
                dst[bound] = v
    dst["zeros"] += src.get("zeros", 0)
    dst["negs"] += src.get("negs", 0)
    for idx, n in (src.get("counts") or {}).items():
        dst["counts"][idx] = dst["counts"].get(idx, 0) + int(n)
    return dst


def hist_percentile(h: dict, pct: float) -> Optional[float]:
    """Nearest-rank percentile of a serialized accumulator — the same
    definition as :meth:`hfrep_tpu_torch.obs.Histogram.percentile` (geometric
    bucket midpoint, clamped to the observed [min, max])."""
    n = h["n"]
    if not n:
        return None
    rank = max(1, math.ceil(n * float(pct) / 100.0))
    acc = h.get("negs", 0)
    if rank <= acc:
        return h["min"]
    acc += h.get("zeros", 0)
    if rank <= acc:
        return 0.0
    for idx in sorted(int(k) for k in h["counts"]):
        acc += h["counts"][str(idx)]
        if rank <= acc:
            lo = 10.0 ** (idx / _HIST_BUCKETS_PER_DECADE)
            hi = 10.0 ** ((idx + 1) / _HIST_BUCKETS_PER_DECADE)
            rep = math.sqrt(lo * hi)
            return min(max(rep, h["min"]), h["max"])
    return h["max"]


def hist_cumulative(h: dict) -> List[Tuple[str, int]]:
    """Cumulative Prometheus buckets ``[(le, count), ..., ('+Inf', n)]``.

    ``le`` is each log-bucket's exact upper edge
    (``10**((idx+1)/100)``); zero and negative samples — which are ≤
    every positive edge — seed the running total so the exposition
    stays monotone."""
    out: List[Tuple[str, int]] = []
    acc = h.get("negs", 0) + h.get("zeros", 0)
    for idx in sorted(int(k) for k in (h.get("counts") or {})):
        acc += h["counts"][str(idx)]
        le = 10.0 ** ((idx + 1) / _HIST_BUCKETS_PER_DECADE)
        out.append((format(le, ".6g"), acc))
    out.append(("+Inf", h["n"]))
    return out


def _num(v):
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f


def _fold_record(state: dict, rec: dict) -> None:
    """One parsed event into its time bucket (+ the fleet facts)."""
    bs = float(state["bucket_secs"]) or DEFAULT_BUCKET_SECS
    key = str(int(math.floor(float(rec["t"]) / bs)))
    bucket = state["buckets"].get(key)
    if bucket is None:
        bucket = state["buckets"][key] = _new_bucket()
    etype = rec["type"]
    bucket["counts"][etype] = bucket["counts"].get(etype, 0) + 1
    if etype == "span":
        name = str(rec["name"])
        s = bucket["spans"].setdefault(
            name, {"n": 0, "total_s": 0.0, "max_s": 0.0})
        dur = _num(rec.get("dur")) or 0.0
        s["n"] += 1
        s["total_s"] += dur
        if dur > s["max_s"]:
            s["max_s"] = dur
    elif etype == "metric":
        name, kind = str(rec["name"]), rec.get("kind")
        if kind == "counter":
            c = bucket["counters"].setdefault(
                name, {"last": 0, "inc": 0, "n": 0})
            c["last"] = rec["value"]
            d = _num(rec.get("delta"))
            if d is not None:
                c["inc"] += d
            c["n"] += 1
        elif kind == "gauge":
            g = bucket["gauges"].setdefault(
                name, {"last": None, "min": None, "max": None,
                       "sum": 0.0, "n": 0})
            g["last"] = rec["value"]
            v = _num(rec["value"])
            if v is not None:
                if g["min"] is None or v < g["min"]:
                    g["min"] = v
                if g["max"] is None or v > g["max"]:
                    g["max"] = v
                g["sum"] += v
            g["n"] += 1
        elif kind == "histogram":
            h = bucket["hists"].setdefault(name, new_hist())
            hist_observe(h, rec["value"])
    elif etype == "event":
        name = str(rec["name"])
        bucket["events"][name] = bucket["events"].get(name, 0) + 1
        _fold_fact(state["facts"], name, rec)


def _fold_fact(facts: dict, name: str, rec: dict) -> None:
    """The cross-replica invariant surface: the handful of lifecycle
    events the fleet watcher reasons about, folded to bounded facts."""
    if name == "serve_drain":
        facts["serve_drain"] = {
            "t": float(rec["t"]),
            "submitted": rec.get("submitted"),
            "terminal": rec.get("terminal"),
            "reason": rec.get("reason"),
            "flushed": rec.get("flushed")}
    elif name == "serve_breaker_open":
        b = facts["breaker"]
        b["opens"] += 1
        b["state"] = "open"
        b["last_t"] = float(rec["t"])
        b["last_reason"] = rec.get("reason")
    elif name == "serve_breaker_close":
        b = facts["breaker"]
        b["closes"] += 1
        b["state"] = "closed"
        b["last_t"] = float(rec["t"])
    elif name == "actor_restart":
        r = facts["restarts"]
        r["n"] += 1
        r["t"] = (r["t"] + [float(rec["t"])])[-_RESTART_TIMES_KEPT:]
        actor = str(rec.get("actor"))
        r["actors"][actor] = r["actors"].get(actor, 0) + 1
    elif name == "run_end":
        facts["run_end"] = True


def totals(state: dict) -> dict:
    """Whole-run fold of the bucketed segments (buckets in time order,
    so last-wins gauges and counter running totals resolve exactly as
    a single linear replay would)."""
    out = _new_bucket()
    for key in sorted(state["buckets"], key=int):
        b = state["buckets"][key]
        for etype, n in b["counts"].items():
            out["counts"][etype] = out["counts"].get(etype, 0) + n
        for name, n in b["events"].items():
            out["events"][name] = out["events"].get(name, 0) + n
        for name, c in b["counters"].items():
            dst = out["counters"].setdefault(
                name, {"last": 0, "inc": 0, "n": 0})
            dst["last"] = c["last"]
            dst["inc"] += c["inc"]
            dst["n"] += c["n"]
        for name, g in b["gauges"].items():
            dst = out["gauges"].setdefault(
                name, {"last": None, "min": None, "max": None,
                       "sum": 0.0, "n": 0})
            dst["last"] = g["last"]
            for bound, better in (("min", min), ("max", max)):
                if g[bound] is not None:
                    dst[bound] = (g[bound] if dst[bound] is None
                                  else better(dst[bound], g[bound]))
            dst["sum"] += g["sum"]
            dst["n"] += g["n"]
        for name, h in b["hists"].items():
            hist_merge(out["hists"].setdefault(name, new_hist()), h)
        for name, s in b["spans"].items():
            dst = out["spans"].setdefault(
                name, {"n": 0, "total_s": 0.0, "max_s": 0.0})
            dst["n"] += s["n"]
            dst["total_s"] += s["total_s"]
            dst["max_s"] = max(dst["max_s"], s["max_s"])
    return out


def n_records(state: dict) -> int:
    """Total event records folded into the segments."""
    return sum(n for b in state["buckets"].values()
               for n in b["counts"].values())


# --------------------------------------------------------------- cursors
def _sig_head(path: Path, sig_len: int) -> Tuple[str, int]:
    with open(path, "rb") as fh:
        data = fh.read(sig_len)
    return hashlib.sha256(data).hexdigest(), len(data)


def _sig_matches(path: Path, cur: dict) -> bool:
    sig_len = int(cur.get("sig_len") or 0)
    if sig_len == 0:
        # nothing consumed yet: identity is vacuous, any file matches
        return int(cur.get("offset") or 0) == 0
    try:
        sig, got = _sig_head(path, sig_len)
    except OSError:
        return False
    return got == sig_len and sig == cur.get("sig")


def _match_cursors(files: List[Path], cursors: Dict[str, dict],
                   ) -> Dict[str, dict]:
    """Pair each present stream with its durable cursor: by name where
    the head signature still matches, else by signature alone (a
    rotation RENAMED the stream; the cursor follows it), else a fresh
    cursor.  Never resets a matched offset — the no-double-count /
    no-drop core of resume."""
    matched: Dict[str, dict] = {}
    used = set()
    pending = []
    for f in files:
        cur = cursors.get(f.name)
        if cur is not None and _sig_matches(f, cur):
            matched[f.name] = dict(cur)
            used.add(f.name)
        else:
            pending.append(f)
    for f in pending:
        adopted = None
        for name, cur in cursors.items():
            if name in used or int(cur.get("sig_len") or 0) == 0:
                continue
            if _sig_matches(f, cur):
                adopted, _ = dict(cur), used.add(name)
                break
        matched[f.name] = adopted or {"offset": 0, "sig": "", "sig_len": 0}
    return matched


def _read_complete(path: Path, offset: int) -> Tuple[List[str], int]:
    """Newline-complete lines past ``offset`` (the shared torn-tail
    discipline: a torn tail is simply not consumed yet)."""
    with open(path, "rb") as fh:
        fh.seek(offset)
        data = fh.read()
    end = data.rfind(b"\n")
    if end < 0:
        return [], offset
    lines = data[:end + 1].decode("utf-8", errors="replace").splitlines()
    return lines, offset + end + 1


def _parse_line(line: str) -> Optional[dict]:
    """Follower discipline: a complete line that fails the schema is
    skipped (a foreign writer's debris must not wedge the consumer),
    exactly like the live tail's ``_StreamFollower``."""
    try:
        return parse_event(line, 0)
    except Exception:
        return None


# ---------------------------------------------------------------- layout
def rollup_dir(run_dir) -> Path:
    return Path(run_dir) / ROLLUP_DIR


def chunk_files(run_dir) -> List[Path]:
    ru = rollup_dir(run_dir)
    if not ru.is_dir():
        return []
    found = []
    for p in ru.iterdir():
        m = CHUNK_RE.match(p.name)
        if m:
            found.append((int(m.group(1)), p))
    return [p for _, p in sorted(found)]


def pinned_files(run_dir) -> List[Path]:
    ru = rollup_dir(run_dir)
    if not ru.is_dir():
        return []
    found = []
    for p in ru.iterdir():
        m = PINNED_RE.match(p.name)
        if m:
            found.append((int(m.group(1)), p))
    return [p for _, p in sorted(found)]


def next_chunk_index(run_dir) -> int:
    """First chunk number never used: neither on disk (chunk or pinned)
    nor in the compaction ledger — a compacted-and-deleted chunk's
    number must never be reissued."""
    taken = set()
    ru = rollup_dir(run_dir)
    if ru.is_dir():
        for p in ru.iterdir():
            m = CHUNK_RE.match(p.name) or PINNED_RE.match(p.name)
            if m:
                taken.add(int(m.group(1)))
    comp = _load_json(ru / COMPACT_NAME) or {}
    for name in (comp.get("chunks") or {}):
        m = CHUNK_RE.match(name)
        if m:
            taken.add(int(m.group(1)))
    n = 1
    while n in taken:
        n += 1
    return n


def _scan_streams(run_dir) -> List[Path]:
    """The streams the consumer follows, oldest first: rotation chunks
    in rotation order, then the live stream.  Previous-RUN rotations
    (``events-<n>.jsonl``) are deliberately excluded — the rollup, like
    ``load_events``, describes THIS run."""
    out = chunk_files(run_dir)
    live = Path(run_dir) / EVENTS_NAME
    if live.exists():
        out.append(live)
    return out


def load_state(run_dir) -> Optional[dict]:
    return _load_json(rollup_dir(run_dir) / STATE_NAME)


def load_compact(run_dir) -> Optional[dict]:
    return _load_json(rollup_dir(run_dir) / COMPACT_NAME)


# ----------------------------------------------------------------- ingest
def ingest(run_dir, *, bucket_secs: float = DEFAULT_BUCKET_SECS,
           persist: bool = True) -> Tuple[dict, int]:
    """Consume every complete line past the durable cursors and fold it
    into the bucketed segments; returns ``(state, records_consumed)``.

    ``persist=False`` folds in memory only (read-only evaluation over
    someone else's run dir — the SLO self-test must not dirty the
    committed fixture).  With ``persist=True`` the updated state —
    segments and advanced cursors in ONE document — is published
    atomically; a crash on either side of that publish re-folds or
    skips the same bytes, never half of them."""
    rd = Path(run_dir)
    state = load_state(rd) or _new_state(bucket_secs)
    files = _scan_streams(rd)
    cursors = _match_cursors(files, state.get("cursors") or {})
    consumed = 0
    for f in files:
        cur = cursors[f.name]
        try:
            lines, new_off = _read_complete(f, int(cur["offset"]))
        except OSError:
            continue
        for line in lines:
            rec = _parse_line(line)
            if rec is not None:
                _fold_record(state, rec)
                consumed += 1
        if new_off != cur["offset"]:
            cur["offset"] = new_off
            sig_len = min(_SIG_BYTES, new_off)
            try:
                cur["sig"], cur["sig_len"] = _sig_head(f, sig_len)
            except OSError:
                continue
    state["cursors"] = {f.name: cursors[f.name] for f in files}
    if persist:
        publish_state(rd, state)
    return state, consumed


def publish_state(run_dir, state: dict) -> None:
    path = rollup_dir(run_dir) / STATE_NAME
    data = _canonical(state)
    try:
        if path.read_bytes() == data:     # idempotent no-op re-ingest
            return
    except OSError:
        pass
    _publish_bytes(path, data)


# --------------------------------------------------------------- rotation
def rotate_live(run_dir, rotate_bytes: int = DEFAULT_ROTATE_BYTES, *,
                force: bool = False) -> Optional[Path]:
    """OFFLINE rotation: rename an oversized live stream to the next
    ``rollup/chunk-<n>.jsonl`` and leave a fresh empty live stream (the
    run dir keeps its shape contract).  The caller must know no writer
    holds the stream open — a live process rotates itself through
    ``Obs`` (writer-side rotation), which reopens its handle."""
    rd = Path(run_dir)
    live = rd / EVENTS_NAME
    try:
        size = live.stat().st_size
    except OSError:
        return None
    if size == 0 or (not force and size < rotate_bytes):
        return None
    ru = rollup_dir(rd)
    ru.mkdir(parents=True, exist_ok=True)
    dst = ru / f"chunk-{next_chunk_index(rd)}.jsonl"
    os.rename(live, dst)
    live.touch()
    return dst


# ------------------------------------------------------------- compaction
def _new_seed() -> dict:
    return {"counts": {}, "gauges": {}, "counters": {}, "hists": {},
            "spans": {}, "span_order": [], "type_order": []}


def pin_record(rec: dict) -> bool:
    """Verbatim-preservation rule: everything the post-mortem readers
    consume record-by-record.  ``event`` records (trace hops, program
    profiles, lifecycle facts, ``run_end``), ``memory`` snapshots, and
    the evidence-bearing spans (``block`` step timing, ``compile:*``
    digests, warmup windows, anything carrying a trace ID) stay whole;
    metric samples and plain spans survive as aggregates only."""
    etype = rec["type"]
    if etype in ("event", "memory"):
        return True
    if etype == "span":
        return bool(rec.get("warmup")
                    or rec["name"] == "block"
                    or str(rec["name"]).startswith("compile:")
                    or isinstance(rec.get("trace"), str)
                    or isinstance(rec.get("traces"), list))
    return False


def _fold_seed(seed: dict, rec: dict, pinned: bool) -> None:
    """Aggregate one compacted record into the reader seed.  Dict
    insertion order IS the contract: the readers re-derive first-seen
    order from it, which keeps their output byte-equal to a raw
    replay."""
    etype = rec["type"]
    if etype not in seed["type_order"]:
        # first-seen TYPE order across every compacted record, pinned
        # included: summarize's event_counts dict order must reproduce
        # the raw stream's
        seed["type_order"].append(etype)
    if etype == "span" and not rec.get("warmup"):
        name = str(rec["name"])
        if name not in seed["span_order"]:
            seed["span_order"].append(name)
    if pinned:
        return
    seed["counts"][etype] = seed["counts"].get(etype, 0) + 1
    if etype == "span":
        name = str(rec["name"])
        s = seed["spans"].setdefault(name, {"n": 0, "total_s": 0.0})
        s["n"] += 1
        s["total_s"] += _num(rec.get("dur")) or 0.0
    elif etype == "metric":
        name, kind = str(rec["name"]), rec.get("kind")
        if kind == "gauge":
            seed["gauges"][name] = rec["value"]
        elif kind == "counter":
            seed["counters"][name] = rec["value"]
        elif kind == "histogram":
            hist_observe(seed["hists"].setdefault(name, new_hist()),
                         rec["value"])


def compact(run_dir, *, bucket_secs: float = DEFAULT_BUCKET_SECS,
            rotate_bytes: Optional[int] = None,
            force_rotate: bool = False) -> dict:
    """Retention pass over one run dir: (optionally) rotate an
    oversized live stream, advance the durable ingest cursors over
    everything, then fold each whole rotation chunk into the reader
    seed + pinned evidence and delete it.

    Per-chunk protocol (each step idempotent, SIGKILL anywhere safe):

    1. fold the chunk against the *published* ledger (a re-run after a
       crash recomputes the identical merge — the source chunk cannot
       have changed);
    2. publish ``pinned-<n>.jsonl`` atomically (same bytes on retry);
    3. publish ``compact.json`` with the chunk entered in the ledger;
    4. unlink the chunk (a crash before this leaves a ledgered chunk
       the next pass merely unlinks).
    """
    rd = Path(run_dir)
    rotated = rotate_live(rd, rotate_bytes, force=force_rotate) \
        if (rotate_bytes is not None or force_rotate) else None
    state, consumed = ingest(rd, bucket_secs=bucket_secs, persist=True)
    ru = rollup_dir(rd)
    comp = load_compact(rd) or {"v": STATE_VERSION, "chunks": {},
                                "seed": _new_seed()}
    compacted = []
    for chunk in chunk_files(rd):
        if chunk.name in comp["chunks"]:
            chunk.unlink()          # crashed after ledger publish: finish
            compacted.append(chunk.name)
            continue
        try:
            lines, _ = _read_complete(chunk, 0)
        except OSError:
            continue
        pinned_lines: List[str] = []
        n_parsed = 0
        for line in lines:
            rec = _parse_line(line)
            if rec is None:
                continue
            n_parsed += 1
            pinned = pin_record(rec)
            _fold_seed(comp["seed"], rec, pinned)
            if pinned:
                pinned_lines.append(line)
        m = CHUNK_RE.match(chunk.name)
        idx = int(m.group(1)) if m else 0
        _publish_bytes(ru / f"pinned-{idx}.jsonl",
                       ("".join(ln + "\n" for ln in pinned_lines)).encode())
        comp["chunks"][chunk.name] = {"records": n_parsed,
                                      "pinned": len(pinned_lines)}
        _publish_bytes(ru / COMPACT_NAME, _canonical(comp))
        chunk.unlink()
        compacted.append(chunk.name)
    return {"rotated": str(rotated) if rotated else None,
            "ingested": consumed, "compacted": compacted,
            "chunks_total": len(comp["chunks"]),
            "records_compacted": sum(c["records"]
                                     for c in comp["chunks"].values())}


# ------------------------------------------------------------ reader seed
def summary_seed(run_dir) -> Optional[dict]:
    """What ``report.summarize`` must pre-load for a compacted run dir:
    the aggregate contribution of the records compaction folded away.
    None when the dir was never compacted (the raw path stays
    untouched)."""
    comp = load_compact(run_dir)
    if not comp or not comp.get("chunks"):
        return None
    seed = comp["seed"]
    return {"counts": dict(seed.get("counts") or {}),
            "type_order": list(seed.get("type_order") or []),
            "gauges": dict(seed.get("gauges") or {}),
            "counters": dict(seed.get("counters") or {}),
            "n_events": sum((seed.get("counts") or {}).values())}


def evidence_seed(run_dir) -> Optional[dict]:
    """What ``explain.run_evidence`` must pre-load: non-warmup span
    aggregates re-ordered to the raw stream's first-seen order (names
    whose records were all pinned get zero placeholders the pinned
    replay then fills), plus last-wins gauge/counter seeds."""
    comp = load_compact(run_dir)
    if not comp or not comp.get("chunks"):
        return None
    seed = comp["seed"]
    spans = {}
    agg = seed.get("spans") or {}
    for name in seed.get("span_order") or []:
        src = agg.get(name)
        spans[name] = ({"n": int(src["n"]), "total_s": float(src["total_s"])}
                       if src else {"n": 0, "total_s": 0.0})
    return {"spans": spans,
            "gauges": dict(seed.get("gauges") or {}),
            "counters": dict(seed.get("counters") or {})}


def disk_footprint(run_dir) -> int:
    """Bytes the telemetry plane holds on disk for one run dir: live
    stream + chunks + rollup artifacts (the bounded-retention soak
    asserts this stays ~flat while raw bytes written grow)."""
    rd = Path(run_dir)
    total = 0
    for p in [rd / EVENTS_NAME] + chunk_files(rd) + pinned_files(rd) + [
            rollup_dir(rd) / STATE_NAME, rollup_dir(rd) / COMPACT_NAME]:
        try:
            total += p.stat().st_size
        except OSError:
            pass
    return total
