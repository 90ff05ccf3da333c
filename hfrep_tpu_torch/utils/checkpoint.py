"""Crash-consistent checkpoint / resume (``hfrep_tpu/utils/checkpoint.py``).

A checkpoint is a directory holding one payload file and ``meta.json``
(caller metadata and a sha256 checksum over every payload file).  The
integrity layer is the JAX package's, line for line: the same checksum
and meta layout, so the JAX package's ``verify`` accepts an intact port
checkpoint and rejects a torn one.

* **Atomic publication**: every save materializes into a hidden tmp
  directory next to the destination, fsyncs it, and becomes visible in
  one ``rename``; an overwrite parks the previous payload at a
  deterministic ``.<name>.prev`` sibling first.
* **Verified restore**: :func:`restore` recomputes the checksum before
  decoding and raises :class:`CheckpointCorrupt` on a torn or rotted
  checkpoint; :func:`restore_latest_good` walks a directory newest
  first, each candidate's ``.prev`` right after it, and falls back.
* **Retention**: ``save(..., keep=N)`` prunes all but the newest N
  numbered siblings (``ckpt_<n>``).
* **Fault injection and retry**: every write passes the
  ``resilience.io_point`` of its site (``ckpt_save``, ``snapshot_save``,
  ``result_save``, ...) inside :func:`~hfrep_tpu_torch.resilience.retry_io`
  (bounded full-jitter backoff), then ``resilience.post_save`` (injected
  torn/corrupt directives); the write's time books into the wall-clock
  ledger's ``checkpoint`` or ``host_io`` category; each fallback past a
  bad checkpoint is a ``ckpt_fallback`` event and counter.

Only the payload differs from the JAX package's: one ``torch.save`` file
(``checkpoint.pt``) of CPU tensors and plain Python values, read back
with ``torch.load(weights_only=True)``, which unpickles tensors and
builtins only.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Any, Callable, List, Optional, Tuple

import torch

from hfrep_tpu_torch import resilience
from hfrep_tpu_torch.obs import get_obs, timeline

META_NAME = "meta.json"
PAYLOAD_NAME = "checkpoint.pt"


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed checksum verification or cannot be decoded
    (torn write, bit rot, truncation)."""


# ---------------------------------------------------------------- checksum
def aggregate_digest(file_digests: dict) -> str:
    """The ``checksum["digest"]`` aggregate for a ``{relpath: sha256}`` map."""
    return hashlib.sha256("\n".join(
        f"{k}:{v}" for k, v in sorted(file_digests.items())).encode()
    ).hexdigest()


def compute_checksum(path) -> dict:
    """sha256 per payload file (sorted relative paths, ``meta.json``
    excluded) plus one aggregate digest over the file list."""
    p = Path(path)
    files = {}
    for f in sorted(p.rglob("*")):
        if f.is_file() and f.name != META_NAME:
            files[f.relative_to(p).as_posix()] = hashlib.sha256(
                f.read_bytes()).hexdigest()
    return {"algo": "sha256", "digest": aggregate_digest(files),
            "files": files}


def read_meta(path) -> Optional[dict]:
    """The embedded ``meta.json``; None for legacy checkpoints without
    one; :class:`CheckpointCorrupt` when present but unparseable."""
    f = Path(path) / META_NAME
    if not f.exists():
        return None
    try:
        return json.loads(f.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorrupt(f"{path}: unreadable {META_NAME}: {e}") from e


def verify(path) -> Optional[dict]:
    """Checksum-verify a checkpoint directory.

    Returns its metadata (None for legacy no-meta checkpoints, which
    cannot be verified); raises :class:`CheckpointCorrupt` on mismatch.
    """
    meta = read_meta(path)
    if meta is None or "checksum" not in meta:
        return meta
    want = meta["checksum"]
    have = compute_checksum(path)
    if have["digest"] != want.get("digest"):
        missing = sorted(set(want.get("files", {})) - set(have["files"]))
        detail = f" (missing files: {missing})" if missing else ""
        raise CheckpointCorrupt(f"{path}: checksum mismatch{detail}")
    return meta


# ------------------------------------------------------------ atomic write
def _fsync_path(p: Path) -> None:
    fd = os.open(p, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def prev_path(dst) -> Path:
    """Where :func:`_atomic_publish` parks the previous payload while
    overwriting ``dst`` (and leaves it, under ``keep_prev=True``)."""
    dst = Path(dst)
    return dst.parent / f".{dst.name}.prev"


def _atomic_publish(tmp: Path, dst: Path, keep_prev: bool = False) -> None:
    """fsync the tree, then swap ``tmp`` into ``dst``.

    A fresh publish is one rename.  Overwriting an existing ``dst``
    cannot be a single rename on POSIX, so the previous payload is first
    parked at :func:`prev_path`: a crash between the two renames leaves
    the last complete payload there.  With ``keep_prev=True`` the parked
    copy is retained even on success."""
    for f in tmp.rglob("*"):
        if f.is_file():
            _fsync_path(f)
    for d in (tmp, *(x for x in tmp.rglob("*") if x.is_dir())):
        try:
            _fsync_path(d)              # not all filesystems fsync dirs
        except OSError:
            pass
    if dst.exists():
        prev = prev_path(dst)
        if prev.exists():
            shutil.rmtree(prev)
        dst.rename(prev)
        tmp.rename(dst)
        if not keep_prev:
            shutil.rmtree(prev, ignore_errors=True)
    else:
        tmp.rename(dst)
    try:
        _fsync_path(dst.parent)
    except OSError:
        pass


def write_atomic(path, writer: Callable[[Path], Optional[dict]],
                 metadata: Optional[dict] = None, *,
                 io_site: str = "ckpt_save", fault_site: str = "ckpt",
                 retry: bool = True, keep_prev: bool = False) -> Path:
    """The one crash-consistent directory writer.

    ``writer(tmp_dir)`` materializes the payload (its optional dict
    return merges into the metadata); the checksummed ``meta.json`` is
    written beside it and the whole directory published atomically."""
    dst = Path(path).absolute()
    dst.parent.mkdir(parents=True, exist_ok=True)
    tmp = dst.parent / f".{dst.name}.tmp-{os.getpid()}"

    def _write():
        resilience.io_point(io_site)
        if tmp.exists():                # a failed earlier attempt
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        meta = dict(metadata or {})
        extra = writer(tmp)
        if extra:
            meta.update(extra)
        meta["checksum"] = compute_checksum(tmp)
        (tmp / META_NAME).write_text(json.dumps(meta, indent=2, default=str))
        _atomic_publish(tmp, dst, keep_prev=keep_prev)

    with timeline.timed("checkpoint" if fault_site in ("ckpt", "snapshot") else "host_io"):
        try:
            if retry:
                resilience.retry_io(_write, what=io_site)
            else:
                _write()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        resilience.post_save(fault_site, dst)
    return dst


def atomic_text(path, text: str) -> Path:
    """Crash-consistent single-file publication: write a hidden tmp
    sibling, fsync, ``os.replace`` into place."""
    dst = Path(path).absolute()
    dst.parent.mkdir(parents=True, exist_ok=True)
    tmp = dst.parent / f".{dst.name}.tmp-{os.getpid()}"
    try:
        tmp.write_text(text, encoding="utf-8")
        _fsync_path(tmp)
        os.replace(tmp, dst)
    finally:
        if tmp.exists():
            tmp.unlink(missing_ok=True)
    try:
        _fsync_path(dst.parent)
    except OSError:
        pass
    return dst


# ------------------------------------------------------------- save/restore
def to_host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor detached on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def _write_payload(tmp: Path, tree: Any) -> dict:
    """Stage the payload, a tree of CPU tensors and plain values, into
    ``tmp`` (a :func:`write_atomic` staging dir)."""
    torch.save(tree, tmp / PAYLOAD_NAME)
    return {"format": "torch"}


def save(path: str, tree: Any, metadata: Optional[dict] = None,
         keep: int = 0) -> str:
    """Atomically write ``tree`` (nested dicts, lists and tuples of
    tensors and plain values; tensors are copied to the CPU) and
    ``metadata`` as a checkpoint.  ``keep > 0`` prunes all but the newest
    ``keep`` siblings sharing this one's numbered naming (``ckpt_<n>``)."""
    p = Path(path).absolute()
    with timeline.timed("checkpoint"):
        tree = to_host(tree)
    write_atomic(p, lambda tmp: _write_payload(tmp, tree), metadata)
    if keep > 0:
        prefix, digits = _split_numbered(p.name)
        if digits is not None:
            retain(p.parent, keep, prefix=prefix)
    return str(p)


def restore(path: str, verify_checksum: bool = True) -> Any:
    """Restore one checkpoint's tree (CPU tensors), checksum-verified
    when it carries a checksum; a decode failure raises
    :class:`CheckpointCorrupt`, so callers can fall back."""
    p = Path(path).absolute()
    if not p.exists():
        raise FileNotFoundError(str(p))
    if verify_checksum:
        verify(p)
    payload = p / PAYLOAD_NAME
    if not payload.exists():
        raise CheckpointCorrupt(f"{p}: no {PAYLOAD_NAME}")
    try:
        return torch.load(payload, map_location="cpu", weights_only=True)
    except Exception as e:
        raise CheckpointCorrupt(f"{p}: payload decode failed: {e}") from e


def restore_latest_good(dirpath: str, prefix: str = "ckpt_",
                        on_exhausted: str = "raise") -> Tuple[Any, str]:
    """Restore the newest checkpoint that verifies and decodes, falling
    back past torn or corrupted ones.

    Returns ``(tree, path)``.  Each candidate's parked ``.prev`` sibling
    is tried right after the candidate itself, and an orphaned ``.prev``
    (a crash between the overwrite's two renames) joins the walk at its
    epoch.  Raises :class:`FileNotFoundError` when the directory holds no
    candidates.  When every candidate fails: ``on_exhausted="raise"``
    raises :class:`CheckpointCorrupt`; ``"fresh"`` returns ``(None, "")``
    so a resume degrades to a clean fresh start."""
    entries = {int(p.name[len(prefix):]): [p, prev_path(p)]
               for p in _numbered(dirpath, prefix)}
    d = Path(dirpath)
    if d.exists():
        for q in d.iterdir():
            name = q.name
            if not (q.is_dir() and name.startswith(f".{prefix}")
                    and name.endswith(".prev")):
                continue
            digits = name[len(prefix) + 1:-len(".prev")]
            if digits.isdigit() and int(digits) not in entries:
                entries[int(digits)] = [q]
    if not entries:
        raise FileNotFoundError(f"no {prefix}* checkpoints under {dirpath}")
    errors: List[str] = []
    for epoch in sorted(entries, reverse=True):
        for attempt in entries[epoch]:
            if not attempt.exists():
                continue
            try:
                out = restore(str(attempt))
            except (CheckpointCorrupt, FileNotFoundError) as e:
                errors.append(f"{attempt.name}: {e}")
                obs = get_obs()
                obs.counter("resilience/ckpt_fallbacks").inc()
                obs.event("ckpt_fallback", skipped=attempt.name, error=str(e))
                continue
            return out, str(attempt)
    detail = (f"no restorable checkpoint under {dirpath}: "
              + "; ".join(errors))
    if on_exhausted == "fresh":
        get_obs().event("ckpt_fallback_exhausted", dir=str(dirpath),
                        candidates=len(entries), error="; ".join(errors))
        return None, ""
    raise CheckpointCorrupt(detail)


# --------------------------------------------------------------- retention
def _split_numbered(name: str) -> Tuple[str, Optional[str]]:
    """``'ckpt_120' -> ('ckpt_', '120')``; non-numbered names get
    ``(name, None)`` and are exempt from retention."""
    i = len(name)
    while i > 0 and name[i - 1].isdigit():
        i -= 1
    digits = name[i:]
    return (name[:i], digits) if digits else (name, None)


def _numbered(dirpath, prefix: str) -> List[Path]:
    """Numbered checkpoint dirs under ``dirpath``, oldest first."""
    d = Path(dirpath)
    if not d.exists():
        return []
    cands = [
        p for p in d.iterdir()
        if p.is_dir() and p.name.startswith(prefix)
        and p.name[len(prefix):].isdigit()
    ]
    cands.sort(key=lambda p: int(p.name[len(prefix):]))
    return cands


def retain(dirpath: str, keep: int, prefix: str = "ckpt_") -> List[str]:
    """Delete all but the newest ``keep`` numbered checkpoints; returns
    the removed paths (best-effort: retention must never fail a save)."""
    if keep <= 0:
        return []
    removed = []
    for doomed in _numbered(dirpath, prefix)[:-keep]:
        shutil.rmtree(doomed, ignore_errors=True)
        removed.append(str(doomed))
    return removed


def latest(dirpath: str, prefix: str = "ckpt_") -> Optional[str]:
    cands = _numbered(dirpath, prefix)
    return str(cands[-1]) if cands else None
