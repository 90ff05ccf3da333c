"""Card-only tests of the port (``hfrep_tpu_torch``); they skip without one.

This file imports no JAX, so it also runs on a machine with a card and
no JAX (``tests/conftest.py`` imports JAX, hence ``--noconftest``)::

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Bars: f32 2e-5 (the kernel's dot sums in another order than
``torch.matmul``), bf16 1e-2 (an h that rounds differently to bf16 feeds
the next step); the generator on the card against its CPU plain path
1e-4 (float32 through two LSTMs and LayerNorm).
"""

from __future__ import annotations

import copy

import pytest
import torch

from hfrep_tpu_torch.ops import cuda_lstm
from hfrep_tpu_torch.serve import aot
from hfrep_tpu_torch.serve.fixture import fixture_gen_model, fixture_server
from hfrep_tpu_torch.serve.loadgen import drive_load, make_panels
from hfrep_tpu_torch.serve.server import ServeConfig

ACTS = ["sigmoid", "tanh", "linear"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,bar", [(torch.float32, 2e-5), (torch.bfloat16, 1e-2)])
def test_kernel_matches_plain_on_card(card, dtype, bar):
    g = torch.Generator(device=card)
    g.manual_seed(0)
    for w, b in ((48, 8), (168, 64)):
        xz = (0.5 * torch.randn(w, b, 400, device=card, generator=g)).to(dtype)
        rec = (0.1 * torch.randn(100, 400, device=card, generator=g)).to(dtype)
        for act in ACTS:
            with torch.no_grad():
                before = cuda_lstm.launches
                hs = cuda_lstm.lstm_seq(xz, rec, act)
                assert cuda_lstm.launches == before + 1
                ref = cuda_lstm.lstm_seq_plain(xz, rec, act)
            torch.cuda.synchronize()
            assert hs.dtype == torch.float32
            assert float((hs - ref).abs().max()) <= bar


@pytest.mark.gpu
def test_kernel_refuses_mixed_devices_and_grad(card):
    xz = torch.zeros(4, 2, 40, device=card)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_lstm.lstm_fwd_cuda(xz, torch.zeros(10, 40), "tanh")
    rec = torch.zeros(10, 40, device=card, requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        cuda_lstm.lstm_fwd_cuda(xz, rec, "tanh")


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ["mtss_wgan_gp", "mtss_wgan_gp_prod"])
def test_generator_on_card_matches_cpu_plain_path(card, preset):
    model = fixture_gen_model(preset, device=card)
    cpu = aot.GenServeModel(cfg=model.cfg, module=copy.deepcopy(model.module).cpu())
    g = torch.Generator()
    g.manual_seed(5)
    noise = torch.randn((8, model.cfg.window, model.cfg.features), generator=g)
    before = cuda_lstm.launches
    got = aot.gen_batch_fn(model)(noise.to(card)).cpu()
    assert cuda_lstm.launches == before + 2          # one launch per LSTM layer
    ref = aot.gen_batch_fn(cpu)(noise)
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_server_on_card_runs_the_kernel(card):
    srv = fixture_server(ServeConfig(request_timeout_ms=60000.0), device=card)
    try:
        srv.warm()
        cuda_lstm.reset_launches()
        report = drive_load(srv, 16, make_panels(0, 22, (24,)), sample_every=2,
                            timeout_ms=60000)
    finally:
        srv.stop()
    assert report["terminal"] == report["submitted"] == report["results"] == 16
    assert cuda_lstm.launches >= 2
