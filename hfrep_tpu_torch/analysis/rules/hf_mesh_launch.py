"""HF008 — single-mesh-API launch discipline, torch form
(``hfrep_tpu/analysis/rules/hf_mesh_launch.py``).

The port's one launch API is :mod:`hfrep_tpu_torch.parallel`: the mesh
(``parallel/rules.py``: ``build_mesh``, its process group and axis
groups), the launches over it (``make_gan_multi_step``, the sp and pp
steps) and every collective a step runs (``Mesh.all_gather_cat``,
``broadcast_``, ``barrier``, ``DataShard.reduce``, the pipeline's sends).
That only stays true if no NEW process group or collective grows
outside the package: a fresh ``torch.distributed.init_process_group`` or
``all_reduce`` in a feature module re-creates exactly the per-path
plumbing (rank wiring, group bookkeeping, the collective counters the
card checks read) the mesh API owns — the JAX rule's ``shard_map`` /
``pmap`` class in PyTorch's spelling.

Flagged: any CALL of ``init_process_group``, ``new_group``,
``all_reduce``, ``broadcast``, ``all_gather``, ``send``, ``recv`` or
``barrier`` from ``torch.distributed`` — as a dotted
``torch.distributed.*`` reference, through a module alias (``import
torch.distributed as dist`` → ``dist.all_reduce(...)``, ``from torch
import distributed`` → ``distributed.barrier()``), or imported bare
(``from torch.distributed import all_reduce [as ar]``) — outside
``hfrep_tpu_torch/parallel/``.  Tests are exempt (fixtures exercise the
rule itself); references without a call, and the availability probes
(``dist.is_initialized()``, ``dist.get_world_size()``), are not
launches.
"""

from __future__ import annotations

import ast
from typing import List, Set

from hfrep_tpu_torch.analysis.engine import FileContext, Finding
from hfrep_tpu_torch.analysis.rules.base import Rule, dotted_name

#: repo-relative posix prefixes where process groups and collectives are
#: built
ALLOWED_PATHS = ("hfrep_tpu_torch/parallel/",)

#: the module whose members below build a group or run a collective
_LAUNCH_MODULE = "torch.distributed"

_LAUNCH_NAMES = {"init_process_group", "new_group", "all_reduce", "broadcast",
                 "all_gather", "send", "recv", "barrier"}


def _launch_aliases(tree: ast.AST) -> Set[str]:
    """Bare names this file binds to a launch via ``from torch.distributed
    import all_reduce [as ar]``."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == _LAUNCH_MODULE:
            for a in node.names:
                if a.name in _LAUNCH_NAMES:
                    out.add(a.asname or a.name)
    return out


def _module_aliases(tree: ast.AST) -> Set[str]:
    """Dotted prefixes this file binds to ``torch.distributed``: ``import
    torch`` (``torch.distributed``), ``import torch.distributed as dist``,
    ``from torch import distributed [as d]``."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == _LAUNCH_MODULE and a.asname is not None:
                    out.add(a.asname)
                elif a.name.split(".")[0] == "torch" and a.asname is None:
                    out.add(_LAUNCH_MODULE)
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            for a in node.names:
                if a.name == "distributed":
                    out.add(a.asname or a.name)
    return out


class MeshLaunchRule(Rule):
    id = "HF008"
    name = "single-mesh-api"
    description = ("process group or collective built outside "
                   "hfrep_tpu_torch/parallel/ — use the mesh API "
                   "(parallel/rules.py build_mesh, the mesh launches)")

    def check(self, ctx: FileContext) -> List[Finding]:
        from hfrep_tpu_torch.analysis.project import _is_test_path

        relpath = ctx.relpath.replace("\\", "/")
        if _is_test_path(relpath):
            return []
        if any(relpath == p or relpath.startswith(p) for p in ALLOWED_PATHS):
            return []
        aliases = _launch_aliases(ctx.tree)
        mod_aliases = _module_aliases(ctx.tree)
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name is None:
                continue
            head, _, tail = name.rpartition(".")
            launch = None
            if not head and name in aliases:
                launch = name
            elif tail in _LAUNCH_NAMES and head in mod_aliases:
                launch = name
            if launch is None:
                continue
            findings.append(ctx.finding(
                "HF008", node,
                f"direct {launch}(...) outside hfrep_tpu_torch/parallel/: the "
                "single-mesh-API discipline routes every process group and "
                "collective through parallel/rules.py's mesh — its groups, "
                "its collective counters, its launches"))
        return findings
