"""The port's checkpoints (``hfrep_tpu_torch/utils/checkpoint.py``): the
JAX package's durability cases (``tests/test_resilience.py``, class
``TestCheckpoint``) carried over to the torch payload, and the shared
integrity layer held to the JAX module itself: its ``verify`` accepts an
intact port checkpoint and rejects a damaged one.  The damage is done
by the JAX package's own fault helpers."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from hfrep_tpu.resilience import faults
from hfrep_tpu.utils import checkpoint as jax_ckpt
from hfrep_tpu_torch.utils import checkpoint as ckpt


def _tree(scale: float = 1.0) -> dict:
    return {"w": torch.arange(4.0) * scale, "n": 3, "nested": {"b": torch.ones(2, 2)}}


def _payload(p) -> Path:
    return faults._payload_file(Path(p))


def test_meta_folded_into_checkpoint_dir(tmp_path):
    p = ckpt.save(str(tmp_path / "ckpt_1"), _tree(), metadata={"epoch": 1})
    meta = ckpt.read_meta(p)
    assert meta["epoch"] == 1
    assert meta["checksum"]["algo"] == "sha256"
    assert meta["format"] == "torch"
    assert sorted(meta["checksum"]["files"]) == [ckpt.PAYLOAD_NAME]
    # no non-atomic sidecar, no leftover tmp dirs
    assert [q.name for q in tmp_path.iterdir()] == ["ckpt_1"]
    out = ckpt.restore(p)
    assert torch.equal(out["w"], torch.arange(4.0)) and out["n"] == 3
    assert torch.equal(out["nested"]["b"], torch.ones(2, 2))


def test_save_copies_tensors_to_the_host(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path / "ckpt_1"), t)
    t["w"].add_(100.0)                 # the caller's tensor moves on
    assert torch.equal(ckpt.restore(str(tmp_path / "ckpt_1"))["w"], torch.arange(4.0))
    host = ckpt.to_host(_tree())
    assert host["w"].device.type == "cpu"


def test_corrupt_restore_raises_and_falls_back(tmp_path):
    ckpt.save(str(tmp_path / "ckpt_1"), _tree())
    p2 = ckpt.save(str(tmp_path / "ckpt_2"), _tree(2.0))
    faults.corrupt_file(_payload(p2))
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.restore(p2)
    out, path = ckpt.restore_latest_good(str(tmp_path))
    assert path.endswith("ckpt_1")
    assert torch.equal(out["w"], torch.arange(4.0))


def test_torn_payload_detected_with_and_without_checksum(tmp_path):
    p = ckpt.save(str(tmp_path / "ckpt_1"), _tree())
    faults.tear_file(_payload(p))
    with pytest.raises(ckpt.CheckpointCorrupt, match="checksum"):
        ckpt.restore(p)
    with pytest.raises(ckpt.CheckpointCorrupt, match="decode"):
        ckpt.restore(p, verify_checksum=False)


def test_fallback_tries_prev_sibling_before_older(tmp_path):
    ckpt.save(str(tmp_path / "ckpt_1"), _tree())
    p2 = ckpt.save(str(tmp_path / "ckpt_2"), _tree(2.0))
    # overwrite ckpt_2 keeping the previous payload parked at .prev
    ckpt.write_atomic(p2, lambda tmp: ckpt._write_payload(tmp, _tree(3.0)),
                      keep_prev=True)
    faults.corrupt_file(_payload(p2))
    out, path = ckpt.restore_latest_good(str(tmp_path))
    assert path.endswith(".ckpt_2.prev")
    assert torch.equal(out["w"], torch.arange(4.0) * 2)


def test_orphaned_prev_is_a_candidate_at_its_epoch(tmp_path):
    ckpt.save(str(tmp_path / "ckpt_1"), _tree())
    p2 = Path(ckpt.save(str(tmp_path / "ckpt_2"), _tree(2.0)))
    p2.rename(ckpt.prev_path(p2))      # a crash between the two renames
    out, path = ckpt.restore_latest_good(str(tmp_path))
    assert path.endswith(".ckpt_2.prev")
    assert torch.equal(out["w"], torch.arange(4.0) * 2)
    only = tmp_path / "only"
    p = Path(ckpt.save(str(only / "ckpt_3"), _tree(2.0)))
    p.rename(ckpt.prev_path(p))
    out, path = ckpt.restore_latest_good(str(only))
    assert path.endswith(".ckpt_3.prev")


def test_all_candidates_corrupt_exhausts(tmp_path):
    for i in (1, 2):
        p = ckpt.save(str(tmp_path / f"ckpt_{i}"), _tree())
        faults.corrupt_file(_payload(p))
    with pytest.raises(ckpt.CheckpointCorrupt, match="no restorable"):
        ckpt.restore_latest_good(str(tmp_path))
    assert ckpt.restore_latest_good(str(tmp_path), on_exhausted="fresh") == (None, "")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_latest_good(str(tmp_path / "empty"))


def test_legacy_checkpoint_without_meta_still_restores(tmp_path):
    legacy = tmp_path / "ckpt_1"
    legacy.mkdir()
    torch.save(_tree(), legacy / ckpt.PAYLOAD_NAME)
    assert ckpt.verify(legacy) is None
    out = ckpt.restore(str(legacy))
    assert torch.equal(out["w"], torch.arange(4.0))
    unreadable = tmp_path / "ckpt_2"
    unreadable.mkdir()
    (unreadable / ckpt.META_NAME).write_text("{not json")
    with pytest.raises(ckpt.CheckpointCorrupt, match="unreadable"):
        ckpt.read_meta(unreadable)


def test_retention_keeps_newest_n_and_latest(tmp_path):
    for e in (1, 2, 3, 4, 10):
        ckpt.save(str(tmp_path / f"ckpt_{e}"), _tree(), keep=2)
    assert sorted(q.name for q in tmp_path.iterdir()) == ["ckpt_10", "ckpt_4"]
    assert ckpt.latest(str(tmp_path)).endswith("ckpt_10")
    assert ckpt.latest(str(tmp_path / "none")) is None
    assert ckpt.retain(str(tmp_path), 1) == [str(tmp_path / "ckpt_4")]
    assert ckpt._split_numbered("ckpt_120") == ("ckpt_", "120")
    assert ckpt._split_numbered("final") == ("final", None)


def test_atomic_text_replaces_in_place(tmp_path):
    p = ckpt.atomic_text(tmp_path / "out" / "r.json", json.dumps({"a": 1}))
    ckpt.atomic_text(p, json.dumps({"a": 2}))
    assert json.loads(p.read_text()) == {"a": 2}
    assert [q.name for q in p.parent.iterdir()] == ["r.json"]


def test_checksum_layout_is_the_jax_packages(tmp_path):
    p = ckpt.save(str(tmp_path / "ckpt_1"), _tree())
    assert ckpt.compute_checksum(p) == jax_ckpt.compute_checksum(p)
    files = {"a": "1", "b/c": "2"}
    assert ckpt.aggregate_digest(files) == jax_ckpt.aggregate_digest(files)


def test_jax_verify_accepts_a_port_checkpoint_and_rejects_a_flipped_one(tmp_path):
    p = ckpt.save(str(tmp_path / "ckpt_1"), _tree(), metadata={"epoch": 1})
    meta = jax_ckpt.verify(p)
    assert meta["epoch"] == 1 and meta["format"] == "torch"
    payload = _payload(p)
    raw = bytearray(payload.read_bytes())
    raw[len(raw) // 2] ^= 0x01                   # one flipped bit
    payload.write_bytes(bytes(raw))
    with pytest.raises(jax_ckpt.CheckpointCorrupt, match="checksum mismatch"):
        jax_ckpt.verify(p)
    with pytest.raises(ckpt.CheckpointCorrupt, match="checksum mismatch"):
        ckpt.verify(p)


def test_restore_refuses_pickled_code(tmp_path):
    """``torch.load(weights_only=True)``: a payload naming a global that
    is not a tensor or builtin fails to decode instead of running."""
    import os

    class Smuggled:
        def __reduce__(self):
            return (os.system, ("true",))

    d = tmp_path / "ckpt_1"
    d.mkdir()
    torch.save({"x": Smuggled()}, d / ckpt.PAYLOAD_NAME)
    with pytest.raises(ckpt.CheckpointCorrupt, match="decode"):
        ckpt.restore(str(d))
