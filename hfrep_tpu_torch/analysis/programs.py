"""The program auditor: graph-level static analysis over every compile
boundary the port owns (``hfrep_tpu/analysis/programs.py``).

The AST phases judge SOURCE; this phase judges the TRACED PROGRAM.  A
declarative registry (:data:`PROGRAM_BOUNDARIES`) names each ownable
compile boundary — the GAN multi/single/conditional steps per family ×
dtype policy, the dp mesh launch through ``parallel/rules.py``, the AE
chunk/init programs (dense, laned, padded, multi-dataset), the serve
programs — with a factory that builds it at tiny fixture shapes (the
JAX registry's, row for row), and the engine traces each to a
``torch.fx.Graph``:

* **serve rows** (``tracer="export"``) audit the program the server
  ships: ``serve/aot.py``'s own ``torch.export`` round trip
  (:func:`~hfrep_tpu_torch.serve.aot.aot_compile`), read back after
  ``torch.export.load``, on the CPU or, with ``device="cuda"``, on the
  card; an ``aot_compile`` that comes back in mode ``"compiled"`` (the
  eager fallback) is a skip note, never a silent pass;
* **step, chunk and init rows** (``tracer="fx"``) trace the eager
  programs on the CPU with ``make_fx``, whatever the device asked for:
  the plain versions run, each hand kernel's recorded as ONE
  ``hfrep.<kernel>`` call (:func:`kernel_calls`) — the node the card's
  program launches — and the step's draws are inputs
  (``train.steps.Draws``), so the trace is deterministic.  A loop row is
  traced twice, its loop one iteration longer the second time (JPX003).

The JPX rules (``rules/jpx_*.py``) run over the graphs:

==========  ============================================================
JPX002      precision-policy conformance — f32 products in a bf16 program
JPX003      a host sync whose count grows with the loop's length
JPX004      retrace hazards — a Python scalar specialised into an export
==========  ============================================================

JAX's JPX001 (donation), JPX005 (sharding) and JPX006 (scan carry) have
no PyTorch meaning: eager PyTorch donates no buffer, places no GSPMD
annotation, and the recurrence is a hand kernel, not a scan.

Findings anchor at the boundary's registry row HERE (``label=...``
line), flow through the shared machinery — ``# noqa: JPXnnn`` on that
row, the audit baseline (``audit_baseline.json``), SARIF with a
``properties.boundary`` join key ``obs explain`` reads — and are cached
per boundary in ``.analysis-programs-cache-torch.json`` keyed by
(defining-module shas, analyzer self-hash, installed torch version), so
a warm audit never imports torch at all.

Tracing is per-boundary fault-isolated: a boundary that cannot be built
or traced records a *skip note* and the audit goes on.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import hashlib
import json
import os
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

from hfrep_tpu_torch.analysis.engine import (REPO_ROOT, FileContext, Finding,
                                             _self_hash, torch_version)
from hfrep_tpu_torch.analysis.rules.jpx_base import PROGRAMS_PATH

#: per-boundary finding cache (gitignored; safe to delete any time), its
#: own name beside the JAX package's ``.analysis-programs-cache.json``
DEFAULT_AUDIT_CACHE = REPO_ROOT / ".analysis-programs-cache-torch.json"
AUDIT_CACHE_VERSION = 1

#: boundary kinds whose program holds a loop the factory can lengthen
LOOP_KINDS = frozenset({"gan_multi", "gan_step", "gan_mesh", "ae_chunk"})
#: the loop lengths the two traces of a loop row take (JPX003)
LOOPS = (2, 3)


@dataclasses.dataclass(frozen=True)
class Boundary:
    """One registered compile boundary.

    ``label`` — unique registry id, ``<runtime vocabulary>[@variant]``;
    the part before ``@`` is the label the same program is fingerprinted
    under at runtime (the ``obs explain`` join key).  ``modules`` —
    repo-relative files whose content defines the traced program (the
    cache/``--changed`` scope).  ``site`` — the :data:`RUNTIME_SITES`
    row this boundary audits.  ``tracer`` — ``"export"`` or ``"fx"``.
    ``factory`` — builds the program, importing torch and the subject
    modules itself so registry introspection stays import-free: an fx
    row's takes the loop length and returns ``(fn, args)`` for
    ``make_fx``; an export row's takes the device (``serve:sample``'s
    also a width and a bucket to build at, the fixture's by default) and
    returns a :class:`ServeBuild`.  ``policy`` — "fp32" | "bf16", the compute-
    dtype promise JPX002 holds the trace to, with ``f32_dot_allow``
    exemptions for deliberate fp32 stages.
    """

    label: str
    kind: str
    modules: Tuple[str, ...]
    site: str
    factory: Optional[Callable] = None
    policy: str = "fp32"
    f32_dot_allow: int = 0
    tracer: str = "fx"
    notes: str = ""


class ServeBuild(NamedTuple):
    """An export row's build: the bucket's program as ``aot_compile``
    returned it, its mode, the served model and the example operands."""

    program: Any
    mode: str
    model: Any
    args: tuple


# ------------------------------------------------------------- factories
# The JAX registry's fixture shapes: window=6, features=4, hidden=8,
# batch=4, 8 training windows, n_critic=2, the loop length as the
# factory's argument (steps_per_call, or chunk epochs); AE n_factors=4,
# latent_dim=3, batch 4, 10 rows.  Everything on the CPU.

def _gan_fixture(family: str, dtype: str, loops: int, cond_dim: int = 0, n_critic: int = 2):
    import torch

    from hfrep_tpu_torch.config import ModelConfig, TrainConfig
    from hfrep_tpu_torch.models.registry import build_conditional_gan
    from hfrep_tpu_torch.train.states import fresh_state
    from hfrep_tpu_torch.train.steps import sample_draws

    mcfg = ModelConfig(family=family, hidden=8, features=4, window=6, dtype=dtype)
    tcfg = TrainConfig(epochs=2, batch_size=4, n_critic=n_critic, steps_per_call=loops)
    g = torch.Generator()
    g.manual_seed(0)
    pair = build_conditional_gan(mcfg, cond_dim, device="cpu", generator=g)
    state = fresh_state(pair.loss, pair.generator, pair.discriminator)
    dataset = torch.zeros((8, 6, 4))
    g.manual_seed(1)
    draws = [sample_draws(g, pair, tcfg, dataset) for _ in range(loops)]
    return tcfg, pair, dataset, state, draws


def _metrics_of(multi, state):
    """A step's traced program: the draws in, the metrics out (the state
    updates in place, as every call of the eager step does)."""
    def program(draws):
        return multi(state, draws)[1]
    return program


def _gan_multi_factory(family: str, dtype: str = "float32"):
    def build(loops: int):
        from hfrep_tpu_torch.train.steps import make_multi_step
        tcfg, pair, dataset, state, draws = _gan_fixture(family, dtype, loops)
        return _metrics_of(make_multi_step(pair, tcfg, dataset), state), (draws,)
    return build


def _gan_train_step_factory(family: str, dtype: str = "float32"):
    def build(loops: int):
        from hfrep_tpu_torch.train.steps import make_train_step
        # the single step's loop is the critic's: n_critic iterations
        tcfg, pair, dataset, state, draws = _gan_fixture(family, dtype, 1, n_critic=loops)
        step = make_train_step(pair, tcfg, dataset)
        return (lambda d: step(state, d)[1]), (draws[0],)
    return build


def _conditional_factory():
    def build(loops: int):
        import torch

        from hfrep_tpu_torch.train.steps import make_conditional_step, make_multi_step
        tcfg, pair, dataset, state, draws = _gan_fixture("gan", "float32", loops,
                                                         cond_dim=3)
        conds = torch.zeros((8, 3))
        step = make_conditional_step(pair, tcfg, dataset, conds)
        return (_metrics_of(make_multi_step(pair, tcfg, dataset, step=step), state),
                (draws,))
    return build


def _mesh_multi_factory():
    def build(loops: int):
        from hfrep_tpu_torch.parallel.rules import (MeshSpec, build_mesh,
                                                    make_gan_multi_step)
        tcfg, pair, dataset, state, draws = _gan_fixture("gan", "float32", loops)
        mesh = build_mesh(MeshSpec(dp=1), device="cpu")
        fn = make_gan_multi_step(pair, tcfg, dataset, mesh)
        return _metrics_of(getattr(fn, "__wrapped__", fn), state), (draws,)
    return build


def _ae_cfg(dtype: str = "float32"):
    from hfrep_tpu_torch.config import AEConfig
    return AEConfig(n_factors=4, latent_dim=3, epochs=2, chunk_epochs=2,
                    batch_size=4, patience=1, dtype=dtype)


def _ae_grid(kind: str, padded: bool = False):
    """The lane grid the engine's drive builds for ``kind`` — one lane,
    2 latent lanes, or 2 datasets × 2 lanes — with the padded semantics
    (8 true rows of 10) on ``padded`` and the multi grid."""
    import torch

    from hfrep_tpu_torch.replication import engine as rep

    cfg = _ae_cfg()
    lead = {"single": (), "lanes": (2,), "multi": (2, 2)}[kind]
    x = torch.zeros((lead[0] if kind == "multi" else 1, 10, 4))
    masks = torch.ones((lead[-1] if lead else 1, cfg.latent_dim))
    rows = rep._rows_info(cfg, [8] * x.shape[0]) if padded or kind == "multi" else None
    g = torch.Generator()
    g.manual_seed(0)
    init = rep.keras_init_params(g, lead, 4, cfg.latent_dim, "cpu")
    return rep._Grid(cfg, x, masks, rows, init, x.shape[0])


def _ae_chunk_factory(kind: str, padded: bool = False):
    def build(loops: int):
        import torch

        grid = _ae_grid(kind, padded)
        perms = torch.stack([torch.randperm(grid.n_train, generator=torch.Generator()
                                            .manual_seed(e)) for e in range(loops)])
        perms = perms.expand((grid.d, grid.l) + perms.shape).contiguous()

        def chunk(perms):
            with torch.no_grad():
                return grid.run(perms)
        return chunk, (perms,)
    return build


def _ae_init_factory():
    def build(loops: int):
        import torch

        from hfrep_tpu_torch.replication import engine as rep

        cfg = _ae_cfg()
        x = torch.zeros((1, 10, 4))
        masks = torch.ones((1, cfg.latent_dim))
        g = torch.Generator()
        g.manual_seed(0)
        init = rep.keras_init_params(g, (), 4, cfg.latent_dim, "cpu")

        def init_program(x, enc, dec):
            with torch.no_grad():
                grid = rep._Grid(cfg, x, masks, None,
                                 {"encoder_kernel": enc, "decoder_kernel": dec}, 1)
                return grid.carry()
        return init_program, (x, init["encoder_kernel"], init["decoder_kernel"])
    return build


def build_serve_replicate(device: str = "cpu", dtype: str = "float32") -> ServeBuild:
    """A replication bucket's program as the server builds it
    (``server._replicate_program``): the fixture head in ``dtype``, zero
    weights, a (2, 32) bucket."""
    import numpy as np
    import torch

    from hfrep_tpu_torch.serve import aot

    cfg = _ae_cfg(dtype)
    params = {"encoder_kernel": np.zeros((4, 3), np.float32),
              "decoder_kernel": np.zeros((3, 4), np.float32)}
    model = aot.AEServeModel.create(cfg, params, device=device)
    args = (model.params, torch.zeros((2, 32, 4), device=model.device),
            torch.full((2,), 32, dtype=torch.int32, device=model.device),
            aot.full_mask(cfg, device=model.device))
    program, mode = aot.aot_compile(aot.ae_batch_fn(model), *args)
    return ServeBuild(program, mode, model, args)


def build_serve_sample(device: str = "cpu", mcfg=None, bucket: int = 2) -> ServeBuild:
    """A sample bucket's program as the server builds it
    (``server._sample_program``): the generator of ``mcfg`` (``None``:
    the fixture's MTSS generator, whose two LSTM layers reach the hand
    kernel) at Keras-default init from seed 0, zero noise as the example
    operand."""
    import torch

    from hfrep_tpu_torch.config import ModelConfig
    from hfrep_tpu_torch.serve import aot

    mcfg = mcfg or ModelConfig(family="mtss_wgan_gp", hidden=8, features=4, window=6)
    g = torch.Generator()
    g.manual_seed(0)
    model = aot.GenServeModel.create(mcfg, device=device, generator=g)
    args = (model.params, torch.zeros((bucket, mcfg.window, mcfg.features),
                                      device=model.device))
    program, mode = aot.aot_compile(aot.gen_batch_fn(model), *args)
    return ServeBuild(program, mode, model, args)


def _serve_replicate_factory(dtype: str = "float32"):
    def build(device: str = "cpu"):
        return build_serve_replicate(device, dtype)
    return build


# -------------------------------------------------------------- registry
_TRAIN_MODULES = ("hfrep_tpu_torch/train/steps.py", "hfrep_tpu_torch/train/states.py",
                  "hfrep_tpu_torch/models/registry.py", "hfrep_tpu_torch/config.py")
_AE_MODULES = ("hfrep_tpu_torch/replication/engine.py",
               "hfrep_tpu_torch/models/autoencoder.py", "hfrep_tpu_torch/config.py")
_SERVE_MODULES = ("hfrep_tpu_torch/serve/aot.py",
                  "hfrep_tpu_torch/models/autoencoder.py",
                  "hfrep_tpu_torch/models/registry.py", "hfrep_tpu_torch/config.py",
                  "hfrep_tpu_torch/ops/cuda_lstm.py")

#: Every label of the JAX registry, letter for letter.  The fx rows run
#: on the CPU whatever ``--device`` says; the serve rows on the device
#: asked for.
PROGRAM_BOUNDARIES: Tuple[Boundary, ...] = (
    Boundary(label="compile:multi_step@gan", kind="gan_multi",
             modules=_TRAIN_MODULES, site="trainer_multi_step",
             factory=_gan_multi_factory("gan")),
    Boundary(label="compile:multi_step@wgan", kind="gan_multi",
             modules=_TRAIN_MODULES, site="trainer_multi_step",
             factory=_gan_multi_factory("wgan")),
    Boundary(label="compile:multi_step@wgan_gp", kind="gan_multi",
             modules=_TRAIN_MODULES, site="trainer_multi_step",
             factory=_gan_multi_factory("wgan_gp")),
    Boundary(label="compile:multi_step@wgan_gp_bf16", kind="gan_multi",
             modules=_TRAIN_MODULES, site="trainer_multi_step",
             factory=_gan_multi_factory("wgan_gp", "bfloat16"), policy="bf16"),
    Boundary(label="compile:multi_step@mtss_bf16", kind="gan_multi",
             modules=_TRAIN_MODULES, site="trainer_multi_step",
             factory=_gan_multi_factory("mtss_wgan_gp", "bfloat16"), policy="bf16",
             notes="the LSTM kernels' calls take bf16 streams (xz, rec)"),
    Boundary(label="compile:train_step@gan", kind="gan_step",
             modules=_TRAIN_MODULES, site="trainer_single_step",
             factory=_gan_train_step_factory("gan")),
    Boundary(label="compile:conditional_step@gan", kind="gan_multi",
             modules=_TRAIN_MODULES + ("hfrep_tpu_torch/scenario/conditional.py",
                                       "hfrep_tpu_torch/models/conditional.py"),
             site="conditional_multi_step", factory=_conditional_factory()),
    Boundary(label="compile:dp_multi_step@gan", kind="gan_mesh",
             modules=_TRAIN_MODULES + ("hfrep_tpu_torch/parallel/rules.py",),
             site="mesh_launch", factory=_mesh_multi_factory(),
             notes="a one-rank dp mesh: the literal single-device step"),
    Boundary(label="ae_chunk:single", kind="ae_chunk",
             modules=_AE_MODULES, site="ae_chunk",
             factory=_ae_chunk_factory("single")),
    Boundary(label="ae_chunk:lanes", kind="ae_chunk",
             modules=_AE_MODULES, site="ae_chunk",
             factory=_ae_chunk_factory("lanes")),
    Boundary(label="ae_chunk:lanes@padded", kind="ae_chunk",
             modules=_AE_MODULES, site="ae_chunk",
             factory=_ae_chunk_factory("lanes", padded=True)),
    Boundary(label="ae_chunk:multi", kind="ae_chunk",
             modules=_AE_MODULES, site="ae_chunk",
             factory=_ae_chunk_factory("multi")),
    Boundary(label="ae_chunk:init", kind="ae_init",
             modules=_AE_MODULES, site="ae_chunk",
             factory=_ae_init_factory(),
             notes="(x, kernels) -> carry: the grid's construction"),
    Boundary(label="serve:replicate", kind="serve",
             modules=_SERVE_MODULES, site="serve_replicate", tracer="export",
             factory=_serve_replicate_factory()),
    Boundary(label="serve:replicate@bf16", kind="serve",
             modules=_SERVE_MODULES, site="serve_replicate", tracer="export",
             factory=_serve_replicate_factory("bfloat16"), policy="bf16"),
    Boundary(label="serve:sample", kind="serve",
             modules=_SERVE_MODULES, site="serve_sample", tracer="export",
             factory=build_serve_sample,
             notes="the MTSS generator, whose LSTM layers are hfrep.lstm_fwd nodes"),
)

BOUNDARIES_BY_LABEL = {b.label: b for b in PROGRAM_BOUNDARIES}


# --------------------------------------------------------- seeded defects
def _seeded_f32_product(device: str = "cpu"):
    """``serve:replicate@bf16``'s program with one float32 product added
    to its error output: exactly one JPX002."""
    import torch

    from hfrep_tpu_torch.serve import aot

    built = build_serve_replicate(device, "bfloat16")
    fn = aot.ae_batch_fn(built.model)

    def leaky(params, x, n_rows, mask):
        recon, err = fn(params, x, n_rows, mask)
        extra = torch.mm(x[:, 0, :], params["encoder_kernel"].float())   # f32 x f32
        return recon, err + extra.sum(dim=-1)
    program, mode = aot.aot_compile(leaky, *built.args)
    return ServeBuild(program, mode, built.model, built.args)


def _seeded_scalar_operand(device: str = "cpu"):
    """``serve:sample``'s program taking a Python float operand (a scale
    on the windows): exactly one JPX004."""
    from hfrep_tpu_torch.serve import aot

    built = build_serve_sample(device)
    fn = aot.gen_batch_fn(built.model)
    args = built.args + (0.5,)
    program, mode = aot.aot_compile(lambda params, noise, scale: fn(params, noise) * scale,
                                    *args)
    return ServeBuild(program, mode, built.model, args)


#: rows that are NOT in the registry: a known defect each, with the one
#: finding the rules must give it — the proof that the rules read the
#: graphs a device builds (``chip_smoke.py``'s ``analysis`` phase, the
#: CPU tests)
SEEDED_DEFECTS: Tuple[Tuple[Boundary, str], ...] = (
    (Boundary(label="seeded:replicate@bf16+f32mm", kind="serve", modules=_SERVE_MODULES,
              site="serve_replicate", tracer="export", factory=_seeded_f32_product,
              policy="bf16"), "JPX002"),
    (Boundary(label="seeded:sample+scalar", kind="serve", modules=_SERVE_MODULES,
              site="serve_sample", tracer="export", factory=_seeded_scalar_operand),
     "JPX004"),
)


# ---------------------------------------------------- runtime-site table
#: Every place the runtime fingerprints a built program (the perf
#: microscope's label vocabulary) or dispatches an owned compile
#: boundary.  ``token`` must appear verbatim in ``file`` — the
#: registry-completeness test greps the live source, so a refactor that
#: moves or renames a boundary breaks THIS table loudly instead of
#: silently dropping audit coverage.  ``audited=True`` rows must be
#: covered by >= 1 PROGRAM_BOUNDARIES entry (matched on ``site``);
#: ``audited=False`` rows carry the reason no static row exists.
RUNTIME_SITES: Dict[str, Dict[str, Any]] = {
    "trainer_multi_step": {
        "file": "hfrep_tpu_torch/train/trainer.py",
        "token": 'instrument_step(',
        "audited": True},
    "trainer_single_step": {
        "file": "hfrep_tpu_torch/train/trainer.py",
        "token": '"single_step"',
        "audited": True},
    "conditional_multi_step": {
        "file": "hfrep_tpu_torch/scenario/conditional.py",
        "token": "make_multi_step(",
        "audited": True},
    "mesh_launch": {
        "file": "hfrep_tpu_torch/parallel/rules.py",
        "token": "_launch_name(mesh, kind)",
        "audited": True},
    "ae_chunk": {
        "file": "hfrep_tpu_torch/replication/engine.py",
        "token": 'dispatch_timer("ae_chunk")',
        "audited": True},
    "serve_replicate": {
        "file": "hfrep_tpu_torch/serve/server.py",
        "token": 'f"serve:replicate:b',
        "audited": True},
    "serve_sample": {
        "file": "hfrep_tpu_torch/serve/server.py",
        "token": 'f"serve:sample:b',
        "audited": True},
    "pp_train_step": {
        "file": "hfrep_tpu_torch/parallel/layer_pipeline.py",
        "token": '"pp_train_step"',
        "audited": False,
        "why": "a stage's program exchanges activations with the other "
               "rank by point-to-point sends inside the step: it needs a "
               "two-rank process group, and its stages run the same "
               "layers the trainer_multi_step rows audit"},
}


#: the JAX package's runtime sites with no counterpart in the port, and why
SITES_WITHOUT_COUNTERPART: Dict[str, str] = {
    "bench_multi_step": "the JAX package's bench.py profiles its own programs; the "
                        "port has no benchmark harness yet",
    "perf_probe": "tools/perf_probe.py's calibration probes time XLA programs; the "
                  "port has no such tool",
}


def discover_label_calls(
        paths: Optional[Sequence[Path]] = None) -> List[Tuple[str, str, str]]:
    """AST-scan the runtime tree for compile-boundary *creation* sites:
    calls to ``instrument_step`` / ``instrument_launch`` /
    ``profile_jitted`` / ``profile_stage`` / ``aot_compile``.  Returns
    ``(repo-relative file, callee, label-prefix)`` triples, where the
    label prefix is the leading literal text of the label argument (""
    when fully dynamic).  The completeness test asserts every triple is
    accounted for by a RUNTIME_SITES row in the same file — a NEW
    runtime boundary added without registry coverage fails tier-1.
    """
    callees = {"instrument_step", "instrument_launch", "profile_jitted",
               "profile_stage", "aot_compile"}
    # the defining/forwarding modules: calls there are the mechanism,
    # not a boundary of their own; chip_smoke.py builds programs to time
    # and check them, each one a row's program
    skip = {"hfrep_tpu_torch/obs/__init__.py", "hfrep_tpu_torch/obs/attrib.py",
            "hfrep_tpu_torch/serve/aot.py", "chip_smoke.py"}
    if paths is None:
        paths = ([*sorted((REPO_ROOT / "hfrep_tpu_torch").rglob("*.py")),
                  *sorted((REPO_ROOT / "tools").glob("torch_*.py")),
                  REPO_ROOT / "chip_smoke.py"])
    out: List[Tuple[str, str, str]] = []
    for f in paths:
        rel = Path(f).resolve().relative_to(REPO_ROOT).as_posix()
        if rel in skip or rel.startswith("hfrep_tpu_torch/analysis/"):
            continue
        try:
            tree = ast.parse(Path(f).read_text(encoding="utf-8"))
        except (OSError, SyntaxError):
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None)
            if name not in callees:
                continue
            out.append((rel, name, _label_prefix(node, name)))
    return out


def _label_prefix(call: ast.Call, callee: str) -> str:
    """Leading literal text of the call's label argument."""
    label: Optional[ast.AST] = None
    for kw in call.keywords:
        if kw.arg in ("label", "name"):
            label = kw.value
    if label is None:
        pos = {"instrument_step": 1, "instrument_launch": 1,
               "profile_jitted": 1, "profile_stage": 0}.get(callee)
        if pos is not None and len(call.args) > pos:
            label = call.args[pos]
    if isinstance(label, ast.Constant) and isinstance(label.value, str):
        return label.value
    if isinstance(label, ast.JoinedStr) and label.values:
        first = label.values[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            return first.value
    return ""


# --------------------------------------------------------------- tracing
def registry_lines() -> Dict[str, int]:
    """label -> 1-based line of its ``label="..."`` registry row here —
    the anchor (and ``# noqa``) line for that boundary's findings."""
    out: Dict[str, int] = {}
    src = Path(__file__).read_text(encoding="utf-8")
    for i, line in enumerate(src.splitlines(), 1):
        for label in BOUNDARIES_BY_LABEL:
            if f'label="{label}"' in line:
                out.setdefault(label, i)
    return out


#: each hand kernel's plain version (module, function) -> the kernel's
#: node name in a make_fx trace
KERNEL_PLAIN_VERSIONS = (
    ("hfrep_tpu_torch.ops.cuda_lstm", "lstm_seq_plain", "lstm_fwd"),
    ("hfrep_tpu_torch.ops.cuda_lstm", "lstm_bwd_plain", "lstm_bwd"),
    ("hfrep_tpu_torch.ops.cuda_lstm", "lstm_adj_plain", "lstm_adj"),
    ("hfrep_tpu_torch.ops.cuda_lstm_stack", "stack_seq_plain", "lstm_stack_fwd"),
    ("hfrep_tpu_torch.ops.cuda_lstm_stack", "stack_bwd_plain", "lstm_stack_bwd"),
    ("hfrep_tpu_torch.ops.cuda_lstm_stack", "stack_adj_plain", "lstm_stack_adj"),
)


class KernelCall:
    """A make_fx node target standing for one hand kernel's launch:
    ``str()`` gives ``hfrep.<kernel>``, the namespace of the dispatcher
    op's node, so the rules read both alike.  Never called: the trace
    records it, it does not run."""

    def __init__(self, name: str):
        self.__name__ = self.__qualname__ = name

    def __str__(self) -> str:
        return f"hfrep.{self.__name__}"

    __repr__ = __str__

    def __call__(self, *args, **kwargs):
        raise RuntimeError(f"{self}: a traced kernel's marker, not a callable")


def _recorded(fn: Callable, target: KernelCall) -> Callable:
    """``fn`` (a plain version) that, under make_fx, runs on the real
    operands with the proxy off and enters the graph as one ``target``
    node whose outputs carry on the operands' dataflow; outside a trace,
    or where autograd must see inside it, ``fn`` itself."""
    import torch
    from torch.fx.experimental import proxy_tensor as pt
    from torch.utils import _pytree

    def call(*args):
        mode = pt.get_proxy_mode()
        leaves = [t for t in _pytree.tree_leaves(args) if isinstance(t, torch.Tensor)]
        if mode is None or (torch.is_grad_enabled() and any(t.requires_grad for t in leaves)):
            return fn(*args)
        tracer = mode.tracer
        with pt.disable_proxy_modes_tracing():
            out = fn(*args)
        proxies = _pytree.tree_map_only(
            torch.Tensor, lambda t: pt.get_proxy_slot(t, tracer).proxy, args)
        node = tracer.create_proxy("call_function", target, proxies, {})
        pt.track_tensor_tree(out, node, constant=None, tracer=tracer)
        return out
    return call


@contextlib.contextmanager
def kernel_calls():
    """While tracing: each kernel's plain version recorded as one
    ``hfrep.<kernel>`` node (:class:`KernelCall`), the node the card's
    program launches, instead of the plain version's step loop."""
    import importlib

    saved = []
    try:
        for mod_name, fn_name, kernel in KERNEL_PLAIN_VERSIONS:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, fn_name)
            saved.append((mod, fn_name, fn))
            setattr(mod, fn_name, _recorded(fn, KernelCall(kernel)))
        yield
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


@contextlib.contextmanager
def _one_fake_mode():
    """One fake-tensor mode for a whole trace: without a tracing context
    make_fx builds a fresh one for every value's metadata, most of a cold
    trace's time.  A torch without the context traces as it is."""
    try:
        from torch._guards import TracingContext, tracing
        from torch._subclasses.fake_tensor import FakeTensorMode
    except ImportError:
        yield
        return
    with tracing(TracingContext(FakeTensorMode(allow_fallback_kernels=True))):
        yield


def fx_graph(fn: Callable, args: tuple):
    """``make_fx(fn)(*args)``'s graph, the kernels recorded as calls.  A
    read of a value back to the host (``.item()``, ``bool(t)``) is
    recorded as its node and answered with the real value, where make_fx
    would refuse it: that node is what JPX003 looks for."""
    from torch.fx.experimental.proxy_tensor import make_fx

    with kernel_calls(), _one_fake_mode():
        return make_fx(fn, _error_on_data_dependent_ops=False)(*args).graph


def export_signature(exported) -> Tuple[tuple, tuple]:
    """An ``ExportedProgram``'s ``(inputs, outputs)`` as
    :class:`~hfrep_tpu_torch.analysis.rules.jpx_base.ProgramContext`
    takes them: ``(kind, name, value)`` rows, ``value`` the placeholder
    node (or the constant where the graph has none)."""
    placeholders = {n.name: n for n in exported.graph.nodes if n.op == "placeholder"}

    def rows(specs, user_kind):
        out = []
        for spec in specs:
            arg = spec.arg
            name = getattr(arg, "name", "")
            kind = getattr(spec.kind, "name", str(spec.kind))
            if kind == user_kind:
                kind = ("tensor" if type(arg).__name__ == "TensorArgument"
                        else "constant")
            elif kind == "CONSTANT_TENSOR":
                kind = "lifted"
            else:
                kind = kind.lower()
            out.append((kind, name, placeholders.get(name, getattr(arg, "value", None))))
        return tuple(out)

    sig = exported.graph_signature
    return rows(sig.input_specs, "USER_INPUT"), rows(sig.output_specs, "USER_OUTPUT")


def trace_boundary(boundary: Boundary, line: int = 1, device: str = "cpu"):
    """Build + trace one boundary; returns a ``ProgramContext`` or
    raises — the caller owns the graceful-skip policy."""
    from hfrep_tpu_torch.analysis.rules.jpx_base import ProgramContext

    if boundary.tracer == "export":
        built = boundary.factory(device)
        if built.mode != "export":
            raise RuntimeError(f"aot_compile came back in mode {built.mode!r}: "
                               "the server ships the eager program, no graph")
        exported = built.program.exported
        inputs, outputs = export_signature(exported)
        return ProgramContext(boundary, graph=exported.graph, inputs=inputs,
                              outputs=outputs, line=line)
    graph = fx_graph(*boundary.factory(LOOPS[0]))
    loop_graph = (fx_graph(*boundary.factory(LOOPS[1]))
                  if boundary.kind in LOOP_KINDS else None)
    return ProgramContext(boundary, graph=graph, loop_graph=loop_graph, line=line)


@dataclasses.dataclass
class AuditResult:
    findings: List[Finding]
    traced: List[str]                       # labels actually traced/cached
    skipped: Dict[str, str]                 # label -> reason
    devices: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def boundary_of(self) -> Dict[str, str]:
        """finding fingerprint -> runtime label (the SARIF/obs join);
        snippets lead with the registry label by construction."""
        return {f.fingerprint: f.snippet.split(" ", 1)[0].split("@", 1)[0]
                for f in self.findings}


def boundary_device(boundary: Boundary, device: str) -> str:
    """Where a row traces: the serve rows on ``device``, the rest on the
    CPU."""
    return device if boundary.tracer == "export" else "cpu"


# ---------------------------------------------------------------- caching
def _boundary_key(boundary: Boundary) -> str:
    h = hashlib.sha256()
    for rel in boundary.modules:
        p = REPO_ROOT / rel
        h.update(rel.encode())
        try:
            h.update(hashlib.sha256(p.read_bytes()).hexdigest().encode())
        except OSError:
            h.update(b"<missing>")
    return h.hexdigest()


def load_audit_cache(path) -> dict:
    try:
        data = json.loads(Path(path).read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError, ValueError):
        return {}
    if (not isinstance(data, dict)
            or data.get("version") != AUDIT_CACHE_VERSION
            or data.get("self") != _self_hash()
            or data.get("torch") != torch_version()):
        return {}
    entries = data.get("entries")
    if not isinstance(entries, dict):
        return {}
    return {k: e for k, e in entries.items() if isinstance(e, dict)}


def save_audit_cache(path, entries: dict) -> None:
    p = Path(path)
    tmp = p.parent / f".{p.name}.tmp-{os.getpid()}"
    try:
        tmp.write_text(json.dumps({
            "version": AUDIT_CACHE_VERSION, "self": _self_hash(),
            "torch": torch_version(), "entries": entries}), encoding="utf-8")
        os.replace(tmp, p)
    except OSError:
        tmp.unlink(missing_ok=True)


# ------------------------------------------------------------- the audit
def audit_boundaries(boundaries: Optional[Sequence[Boundary]] = None,
                     rules: Optional[Sequence] = None,
                     cache_path=None, use_cache: bool = True,
                     restrict_to: Optional[Set[str]] = None,
                     device: str = "cpu") -> AuditResult:
    """Trace + rule-check every registered boundary.

    ``restrict_to`` (the ``--changed`` scope): repo-relative paths —
    only boundaries whose ``modules`` intersect it are audited.
    ``device`` is where the serve rows build (the fx rows trace on the
    CPU).  Per-boundary results are cached keyed on the defining
    modules' shas and the device (plus, at the document level, the
    analyzer self-hash and the installed torch version); an all-warm
    audit therefore never imports torch.  ``# noqa: JPXnnn`` on a
    registry row filters that row's findings here, at report time,
    through the ordinary FileContext.
    """
    from hfrep_tpu_torch.analysis.rules import PROGRAM_RULES

    boundaries = (list(boundaries) if boundaries is not None
                  else list(PROGRAM_BOUNDARIES))
    rules = list(rules) if rules is not None else list(PROGRAM_RULES)
    cache_file = Path(cache_path) if cache_path else DEFAULT_AUDIT_CACHE
    cache = load_audit_cache(cache_file) if use_cache else {}
    lines = registry_lines()

    findings: List[Finding] = []
    traced: List[str] = []
    skipped: Dict[str, str] = {}
    devices: Dict[str, str] = {}
    rule_ids = ",".join(r.id for r in rules)

    for b in boundaries:
        if restrict_to is not None and not set(b.modules) & restrict_to:
            continue
        if b.factory is None:
            skipped[b.label] = b.notes or "no factory registered"
            continue
        dev = boundary_device(b, device)
        devices[b.label] = dev
        key = f"{_boundary_key(b)}:{rule_ids}"
        # cache slot per (label, rule set, device): a ``--select`` run
        # must not evict the full-rule entries the warm path relies on
        slot = f"{b.label}::{rule_ids}::{dev}"
        entry = cache.get(slot)
        if entry and entry.get("key") == key:
            try:
                cached = [Finding(**fd) for fd in entry.get("findings", [])]
            except TypeError:
                cached = None
            if cached is not None:
                if entry.get("skip"):
                    skipped[b.label] = str(entry["skip"])
                else:
                    traced.append(b.label)
                findings.extend(cached)
                continue
        line = lines.get(b.label, 1)
        try:
            pctx = trace_boundary(b, line=line, device=dev)
        except Exception as e:     # graceful per-boundary skip, by contract
            reason = f"{type(e).__name__}: {e}"
            skipped[b.label] = reason
            cache[slot] = {"key": key, "findings": [], "skip": reason}
            continue
        b_findings: List[Finding] = []
        for rule in rules:
            b_findings.extend(rule.check_program(pctx))
        traced.append(b.label)
        cache[slot] = {"key": key, "skip": None,
                       "findings": [dataclasses.asdict(f) for f in b_findings]}
        findings.extend(b_findings)

    if use_cache:
        save_audit_cache(cache_file, {
            slot: e for slot, e in cache.items()
            if slot.split("::", 1)[0] in BOUNDARIES_BY_LABEL})

    findings = _apply_registry_noqa(findings)
    findings.sort(key=lambda f: (f.line, f.rule, f.snippet))
    return AuditResult(findings=findings, traced=traced, skipped=skipped,
                       devices=devices)


def _apply_registry_noqa(findings: List[Finding]) -> List[Finding]:
    src_path = REPO_ROOT / PROGRAMS_PATH
    try:
        ctx = FileContext(src_path, src_path.read_text(encoding="utf-8"),
                          relpath=PROGRAMS_PATH)
    except (OSError, SyntaxError):
        return findings
    return [f for f in findings if not ctx.suppressed(f)]
