"""Resume state for the chunked AE drives and the streaming actors
(``hfrep_tpu/resilience/snapshot.py``).

:class:`ChunkSnapshot` persists everything a chunked drive needs to
resume bit-identically at a chunk boundary: the lane carry (a dict of
tensors: params, optimizer slots, early-stopping registers), the traces
so far, the epoch position, the chunk counter and the all-stopped flag.
The permutation draws are not stored — they are a pure function of the
drive's seed and the epoch — so the snapshot's fingerprint pins their
identity instead (config, kind, lanes and a digest of the operands), and
a snapshot is never resumed against another run's data.

Storage is the crash-consistent writer of
:mod:`hfrep_tpu_torch.utils.checkpoint`: the tensors copied to the host
into one ``state.npz``, the fingerprint and counters in the checksummed
``meta.json``, published in one rename with the previous boundary kept
as the ``.prev`` sibling.  A missing, foreign (fingerprint mismatch) or
corrupt snapshot degrades to the previous good one, then to a fresh
start, with a ``snapshot_*`` obs event — resume is an optimisation,
never a correctness hazard.

:class:`ProgressSnapshot` is the streaming actors' sub-block position,
through the same writer.
"""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hfrep_tpu_torch.utils import checkpoint as ckpt

SNAPSHOT_NAME = "chunk_snapshot"


def _leaves(a) -> list:
    """A tensor, array or scalar, or a dict (by sorted key) / list /
    tuple of them, flattened in the order the JAX package's pytrees
    flatten."""
    if isinstance(a, dict):
        return [x for k in sorted(a) for x in _leaves(a[k])]
    if isinstance(a, (list, tuple)):
        return [x for v in a for x in _leaves(v)]
    return [a]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def digest_arrays(*arrays) -> str:
    """Order-sensitive sha256 over the dtype, shape and bytes of
    (dicts/lists of) arrays or tensors; ``None`` entries hash as a marker
    so fingerprints stay aligned across optional operands.  On the same
    numpy arrays it is the JAX package's digest."""
    h = hashlib.sha256()
    for a in arrays:
        if a is None:
            h.update(b"<none>")
            continue
        for leaf in _leaves(a):
            arr = _host(leaf)
            h.update(str(arr.dtype).encode())
            h.update(str(arr.shape).encode())
            h.update(arr.tobytes())
    return h.hexdigest()


def _event(name: str, **attrs) -> None:
    from hfrep_tpu_torch.obs import get_obs
    get_obs().event(name, **attrs)


class ChunkSnapshot:
    """One drive's resume state under ``<dir>/chunk_snapshot/``."""

    def __init__(self, dirpath, fingerprint: dict):
        self.dir = Path(dirpath)
        self.path = self.dir / SNAPSHOT_NAME
        # normalise through JSON so load()'s comparison can't fail on
        # tuple-vs-list or numpy scalar types
        self.fingerprint = json.loads(json.dumps(fingerprint, default=str))

    # ------------------------------------------------------------- write
    def stage(self, carry: Dict[str, torch.Tensor], traces: Tuple, pos: int,
              chunks: int, stopped_all: bool) -> tuple:
        """Copy a boundary's state to the host WITHOUT writing it: the
        drive updates the carry in place, so the copy must be taken at
        the boundary; the staged payload is plain numpy."""
        state = {k: _host(v).copy() for k, v in carry.items()}
        trs = [_host(t).copy() for t in traces]
        return (state, trs, int(pos), int(chunks), bool(stopped_all))

    def commit(self, staged: tuple) -> None:
        """Atomically publish a staged payload; the previous boundary stays
        as the ``.prev`` sibling, so a kill mid-commit costs one chunk."""
        state, trs, pos, chunks, stopped_all = staged

        def writer(tmp: Path) -> None:
            np.savez(tmp / "state.npz",
                     **{f"trace_{i}": t for i, t in enumerate(trs)},
                     **{f"carry_{k}": v for k, v in state.items()})

        ckpt.write_atomic(
            self.path, writer,
            metadata={"fingerprint": self.fingerprint, "pos": int(pos),
                      "chunks": int(chunks), "stopped_all": bool(stopped_all),
                      "carry": sorted(state), "n_traces": len(trs)},
            io_site="snapshot_save", fault_site="snapshot", keep_prev=True)

    def save(self, carry: Dict[str, torch.Tensor], traces: Tuple, pos: int,
             chunks: int, stopped_all: bool) -> None:
        """Stage and commit in one call."""
        self.commit(self.stage(carry, traces, pos, chunks, stopped_all))

    # -------------------------------------------------------------- read
    def load(self, carry_template: Dict[str, torch.Tensor]):
        """``(carry, traces, pos, chunks, stopped_all)`` or None, the carry
        and traces as CPU tensors.  ``carry_template`` names the carry's
        entries; the live snapshot is tried first, then ``.prev``."""
        for path in (self.path, ckpt.prev_path(self.path)):
            out = self._load_one(path, carry_template)
            if out is not None:
                return out
        return None

    def _load_one(self, path: Path, carry_template):
        if not (path / ckpt.META_NAME).exists():
            return None
        try:
            meta = ckpt.verify(path)
        except ckpt.CheckpointCorrupt as e:
            _event("snapshot_corrupt", path=str(path), error=str(e))
            return None
        if meta is None or meta.get("fingerprint") != self.fingerprint:
            _event("snapshot_mismatch", path=str(path))
            return None
        if meta.get("carry") != sorted(carry_template):
            _event("snapshot_mismatch", path=str(path), carry=meta.get("carry"))
            return None
        try:
            with np.load(path / "state.npz") as z:
                carry = {k: torch.from_numpy(z[f"carry_{k}"]) for k in carry_template}
                traces = tuple(torch.from_numpy(z[f"trace_{i}"])
                               for i in range(int(meta["n_traces"])))
        except Exception as e:
            _event("snapshot_corrupt", path=str(path), error=str(e))
            return None
        return (carry, traces, int(meta["pos"]), int(meta["chunks"]),
                bool(meta["stopped_all"]))

    def clear(self) -> None:
        """Remove the snapshot (and its ``.prev`` twin) after a completed
        drive — a stale snapshot would short-circuit the next one."""
        shutil.rmtree(self.path, ignore_errors=True)
        shutil.rmtree(ckpt.prev_path(self.path), ignore_errors=True)

    def exists(self) -> bool:
        return (self.path / ckpt.META_NAME).exists()


class ProgressSnapshot:
    """Sub-block progress of a streaming actor, crash-consistent.

    A generator actor streams a *block* of items into the queue; this
    snapshot persists its position after every item through the same
    atomic writer, so a SIGKILLed member restarted by the supervisor
    rejoins the stream at its next undelivered item.  The fingerprint
    refuses snapshots from another (source, stream) assignment."""

    def __init__(self, dirpath, fingerprint: dict, name: str = "actor_snapshot"):
        self.dir = Path(dirpath)
        self.path = self.dir / name
        self.fingerprint = json.loads(json.dumps(fingerprint, default=str))

    def save(self, progress: dict) -> None:
        def writer(tmp: Path) -> None:
            (tmp / "progress.json").write_text(json.dumps(progress, default=str))

        ckpt.write_atomic(
            self.path, writer, metadata={"fingerprint": self.fingerprint},
            io_site="snapshot_save", fault_site="snapshot", keep_prev=True)

    def load(self) -> Optional[dict]:
        """The persisted progress dict, or None (absent / foreign /
        corrupt — the actor starts its block from the beginning)."""
        for path in (self.path, ckpt.prev_path(self.path)):
            if not (path / ckpt.META_NAME).exists():
                continue
            try:
                meta = ckpt.verify(path)
            except ckpt.CheckpointCorrupt as e:
                _event("snapshot_corrupt", path=str(path), error=str(e))
                continue
            if meta is None or meta.get("fingerprint") != self.fingerprint:
                _event("snapshot_mismatch", path=str(path))
                continue
            try:
                return json.loads((path / "progress.json").read_text())
            except (OSError, json.JSONDecodeError) as e:
                _event("snapshot_corrupt", path=str(path), error=str(e))
        return None

    def clear(self) -> None:
        shutil.rmtree(self.path, ignore_errors=True)
        shutil.rmtree(ckpt.prev_path(self.path), ignore_errors=True)
