"""Serving's export path (``serve/aot.py::aot_compile``, ``ServeConfig.via_export``)
and the forward kernel's dispatcher op ``hfrep::lstm_fwd``, mirroring the
JAX package's ``tests/test_serve.py`` export cases.

* the op is registered; on the CPU it is the plain version bit for bit,
  and its fake implementation gives hs (and cs) float32 (W, B, H) from
  shapes alone; the no-grad forward reaches it, the training route's
  autograd nodes do not;
* an export round trip (``torch.export`` → save → load) runs bit for bit
  the eager program, for each of the six generator families and for the
  AE head, and agrees with the JAX package's own export round trip on
  the same params at the serve tests' f32 bar (atol 1e-5, rtol 1e-4);
  the exported graph of an LSTM generator holds one ``hfrep.lstm_fwd``
  node a layer, so the kernel was not traced away into plain ops, and
  the served weights are its operands, not a copy inside it;
* ``via_export=False`` gives ``"compiled"``, and an export that fails
  serves the eager program with its reason on stderr; a labelled build
  is fingerprinted at ``<label>:export`` or ``<label>:compiled``;
* a server with export on answers bit for bit as one with export off;
* the ``serve`` verb prints ``export=on``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from hfrep_tpu.config import AEConfig as JaxAEConfig
from hfrep_tpu.config import ModelConfig as JaxModelConfig
from hfrep_tpu.models.registry import build_gan as jax_build_gan
from hfrep_tpu.serve import aot as jax_aot
from hfrep_tpu_torch.config import AEConfig, ModelConfig
from hfrep_tpu_torch.experiments.cli import main
from hfrep_tpu_torch.ops import cuda_lstm
from hfrep_tpu_torch.serve import aot, torch_export_supported
from hfrep_tpu_torch.serve.fixture import fixture_server
from hfrep_tpu_torch.serve.server import ServeConfig

FAMILIES = ["gan", "wgan", "wgan_gp", "mtss_gan", "mtss_wgan", "mtss_wgan_gp"]
FEATS = 6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _panel(rows, feats=FEATS, seed=0):
    return (np.random.default_rng(seed).normal(size=(rows, feats)) * 0.02).astype(np.float32)


# ----------------------------------------------------------------- the op
def test_lstm_fwd_op_is_registered_and_is_the_plain_version_on_the_cpu():
    assert torch_export_supported()
    assert torch.ops.hfrep.lstm_fwd.default is not None
    g = torch.Generator()
    g.manual_seed(0)
    xz, rec = torch.randn(7, 3, 20, generator=g), torch.randn(5, 20, generator=g) * 0.3
    for with_cs in (False, True):
        got = torch.ops.hfrep.lstm_fwd(xz, rec, "sigmoid", with_cs)
        want = cuda_lstm.lstm_seq_plain(xz, rec, "sigmoid", with_cs)
        want = list(want) if with_cs else [want]
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_cs", [False, True])
def test_lstm_fwd_fake_gives_shapes_and_dtypes(dtype, with_cs):
    with FakeTensorMode():
        xz = torch.empty((48, 8, 400), dtype=dtype, device="cuda")
        rec = torch.empty((100, 400), dtype=dtype, device="cuda")
        out = torch.ops.hfrep.lstm_fwd(xz, rec, "tanh", with_cs)
    assert len(out) == (2 if with_cs else 1)
    for t in out:
        assert tuple(t.shape) == (48, 8, 100) and t.dtype == torch.float32
        assert t.device.type == "cuda"


def test_no_grad_forward_reaches_the_op_and_training_does_not():
    lstm = cuda_lstm.keras_lstm
    g = torch.Generator()
    g.manual_seed(1)
    k, r, b = (torch.randn(s, generator=g) * 0.3 for s in ((4, 12), (3, 12), (12,)))
    x = torch.randn(2, 5, 4, generator=g)
    ops = _Ops()
    with ops, torch.no_grad():
        lstm(k, r, b, x, "sigmoid")
    assert ops.names.count("hfrep.lstm_fwd.default") == 1
    ops = _Ops()
    k.requires_grad_(True)
    with ops:
        lstm(k, r, b, x, "sigmoid").sum().backward()
    assert "hfrep.lstm_fwd.default" not in ops.names


# ------------------------------------------------------- export round trip
def _lstm_nodes(program) -> int:
    return sum(n.op == "call_function" and "hfrep.lstm_fwd" in str(n.target)
               for n in program.fn.graph.nodes)


@pytest.mark.parametrize("family", FAMILIES)
def test_export_roundtrip_generator_bitwise(family):
    jcfg = JaxModelConfig(family=family, hidden=8, features=4, window=6)
    noise = np.random.default_rng(0).normal(size=(2, 6, 4)).astype(np.float32)
    jparams = jax_build_gan(jcfg).generator.init(jax.random.PRNGKey(1),
                                                 jnp.asarray(noise))["params"]
    jmodel = jax_aot.GenServeModel.create(jcfg, jparams)
    jfn = jax_aot.gen_batch_fn(jmodel)
    model = aot.GenServeModel.create(ModelConfig(family=family, hidden=8, features=4,
                                                 window=6),
                                     jax.tree_util.tree_map(np.asarray, jparams),
                                     device="cpu")
    fn = aot.gen_batch_fn(model)
    x = torch.from_numpy(noise)
    with torch.inference_mode():
        eager = fn(model.params, x)
    rt, mode = aot.aot_compile(fn, model.params, x, via_export=True)
    assert mode == rt.mode == "export"
    assert torch.equal(rt(model.params, x), eager)
    assert _lstm_nodes(rt) == (2 if family.startswith("mtss") else 0)
    # the weights are operands of the program, not state inside it
    assert not any(n.op == "get_attr" and "kernel" in str(n.target)
                   for n in rt.fn.graph.nodes)
    if jax_aot.jax_export_supported():
        jrt, jmode = jax_aot.aot_compile(jfn, jmodel.params, jnp.asarray(noise),
                                         via_export=True)
        assert jmode == "export"
        np.testing.assert_allclose(eager.numpy(), np.asarray(jrt(jmodel.params,
                                                                  jnp.asarray(noise))),
                                   atol=1e-5, rtol=1e-4)


def _ae_case():
    g = np.random.default_rng(4)
    lim = np.sqrt(6.0 / (FEATS + 4))
    params = {"encoder_kernel": g.uniform(-lim, lim, (FEATS, 4)).astype(np.float32),
              "decoder_kernel": g.uniform(-lim, lim, (4, FEATS)).astype(np.float32)}
    panels = [_panel(16), _panel(12, seed=3)]
    return params, panels


def test_export_roundtrip_ae_head_bitwise():
    params, panels = _ae_case()
    cfg = AEConfig(n_factors=FEATS, latent_dim=4)
    model = aot.AEServeModel.create(cfg, params, device="cpu")
    x, n = aot.pad_panel_batch(panels, 2, 16, FEATS, device="cpu")
    mask = aot.full_mask(cfg, device="cpu")
    fn = aot.ae_batch_fn(model)
    with torch.inference_mode():
        eager = fn(model.params, x, n, mask)
    rt, mode = aot.aot_compile(fn, model.params, x, n, mask, via_export=True)
    assert mode == "export"
    got = rt(model.params, x, n, mask)
    assert all(torch.equal(a, b) for a, b in zip(got, eager))
    jmodel = jax_aot.AEServeModel.create(JaxAEConfig(n_factors=FEATS, latent_dim=4), params)
    jx, jn = jax_aot.pad_panel_batch(panels, batch=2, rows=16, feats=FEATS)
    args = (jmodel.params, jx, jn, jax_aot.full_mask(jmodel.cfg))
    if jax_aot.jax_export_supported():
        jrt, _ = jax_aot.aot_compile(jax_aot.ae_batch_fn(jmodel), *args, via_export=True)
        for a, b in zip(got, jrt(*args)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-4)


def test_compiled_mode_and_a_failed_export(capsys):
    params, panels = _ae_case()
    cfg = AEConfig(n_factors=FEATS, latent_dim=4)
    model = aot.AEServeModel.create(cfg, params, device="cpu")
    x, n = aot.pad_panel_batch(panels, 2, 16, FEATS, device="cpu")
    mask = aot.full_mask(cfg, device="cpu")
    fn = aot.ae_batch_fn(model)
    comp, mode = aot.aot_compile(fn, model.params, x, n, mask, via_export=False)
    assert mode == comp.mode == "compiled"
    exp, _ = aot.aot_compile(fn, model.params, x, n, mask)
    assert all(torch.equal(a, b) for a, b in zip(comp(model.params, x, n, mask),
                                                exp(model.params, x, n, mask)))
    # a data-dependent branch cannot be exported at static shapes: the
    # eager program serves, and the reason is on stderr
    def branchy(v: torch.Tensor) -> torch.Tensor:
        return v * 2.0 if float(v.sum()) > 0 else v

    prog, mode = aot.aot_compile(branchy, torch.ones(3), label="serve:test")
    assert mode == "compiled" and torch.equal(prog(torch.ones(3)), torch.full((3,), 2.0))
    assert "serve: serve:test: torch.export round trip failed" in capsys.readouterr().err


def test_bucket_boundary_is_fingerprinted_by_mode(tmp_path):
    """With telemetry on, a labelled build records its boundary as
    ``<label>:export`` (or ``:compiled``), as the JAX package's does."""
    from hfrep_tpu_torch import obs as obs_pkg
    from hfrep_tpu_torch.obs import report

    params, panels = _ae_case()
    cfg = AEConfig(n_factors=FEATS, latent_dim=4)
    model = aot.AEServeModel.create(cfg, params, device="cpu")
    x, n = aot.pad_panel_batch(panels, 2, 16, FEATS, device="cpu")
    mask = aot.full_mask(cfg, device="cpu")
    with obs_pkg.session(tmp_path / "run"):
        for on in (True, False):
            aot.aot_compile(aot.ae_batch_fn(model), model.params, x, n, mask, via_export=on,
                            label="serve:replicate:b2r16")
    programs = [r.get("program") for r in report.load_events(tmp_path / "run")
                if r.get("name") == "program_profile"]
    assert programs == ["serve:replicate:b2r16:export", "serve:replicate:b2r16:compiled"]


# --------------------------------------------------------------- the server
def _cfg(via_export: bool) -> ServeConfig:
    return ServeConfig(max_batch=2, batch_window_ms=1.0, request_timeout_ms=60000.0,
                       max_queue=16, workers=1, row_buckets=(16, 32), sample_buckets=(2,),
                       via_export=via_export)


def test_server_with_export_on_answers_as_with_export_off():
    """The same models behind two servers, one request at a time (so each
    dispatch is the same bucket and the same noise sequence number): every
    answer bit for bit equal; the programs are all ``export`` in one and
    all ``compiled`` in the other."""
    params, _ = _ae_case()
    ae = aot.AEServeModel.create(AEConfig(n_factors=FEATS, latent_dim=4), params,
                                 device="cpu")
    gen = aot.GenServeModel.create(ModelConfig(family="mtss_wgan_gp", hidden=8,
                                               features=FEATS, window=5),
                                   device="cpu", generator=torch.Generator().manual_seed(3))
    answers, modes = {}, {}
    for on in (True, False):
        srv = fixture_server(_cfg(on), preset=None, gen_model=gen, ae_model=ae,
                             device="cpu")
        try:
            n = srv.warm()
            got = []
            for i, rows in enumerate((5, 16, 23, 9)):
                got.append(srv.replicate(_panel(rows, seed=i), timeout_ms=60000)
                           .result(timeout=60).value["reconstruction"])
                got.append(srv.sample(1, timeout_ms=60000).result(timeout=60)
                           .value["windows"])
            answers[on], modes[on] = got, srv.stats()["cache"]["modes"]
        finally:
            srv.stop()
    assert modes[True] == {"export": n} and modes[False] == {"compiled": n}
    assert all(np.array_equal(a, b) for a, b in zip(answers[True], answers[False]))


def test_serve_verb_prints_export_on(capsys):
    assert main(["serve", "--device", "cpu", "--requests", "4", "--fixture-feats", "8",
                 "--max-batch", "2", "--timeout-ms", "60000"]) == 0
    captured = capsys.readouterr()
    assert "AOT programs resident (export=on); offering 4 queries" in captured.err
    assert "torch.export round trip failed" not in captured.err
