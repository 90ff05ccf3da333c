"""Card-only tests of the port (``hfrep_tpu_torch``); they skip without one.

This file imports no JAX, so it also runs on a machine with a card and
no JAX (``tests/conftest.py`` imports JAX, hence ``--noconftest``)::

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Bars: f32 2e-5 (the kernel's dot sums in another order than
``torch.matmul``), bf16 1e-2 (an h that rounds differently to bf16 feeds
the next step); the generator on the card against its CPU plain path
1e-4 (float32 through two LSTMs and LayerNorm).  The backward and
adjoint kernels: max|kernel - plain| / max(1, max|plain|) within 1e-4 in
f32 (drec and urec are sums over W*B rows in another order) and 1e-2 in
bf16.  The fused stack's kernels (forward, backward in every mode,
adjoint) against their plain versions at the same scaled bars.  One
training epoch on the card against the same epoch on the CPU plain
path, on the fused and the chained critic route: the JAX package's bar
for its kernel-vs-scan epoch.
"""

from __future__ import annotations

import copy
import dataclasses

import pytest
import torch

from hfrep_tpu_torch.config import get_preset
from hfrep_tpu_torch.models.registry import build_gan
from hfrep_tpu_torch.ops import cuda_lstm, cuda_lstm_stack
from hfrep_tpu_torch.serve import aot
from hfrep_tpu_torch.serve.fixture import fixture_gen_model, fixture_server
from hfrep_tpu_torch.serve.loadgen import drive_load, make_panels
from hfrep_tpu_torch.serve.server import ServeConfig
from hfrep_tpu_torch.train import Draws, init_gan_state, make_train_step, sample_draws

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
    """The raw wrappers take no tensor that needs a gradient; the
    differentiable entry is ``lstm_seq`` (see the next test)."""
    xz = torch.zeros(4, 2, 40, device=card)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_lstm.lstm_fwd_cuda(xz, torch.zeros(10, 40), "tanh")
    rec = torch.zeros(10, 40, device=card, requires_grad=True)
    with pytest.raises(NotImplementedError, match="not differentiable"):
        cuda_lstm.lstm_fwd_cuda(xz, rec, "tanh")


def _scaled(got, ref):
    return float((got.float().cpu() - ref.float().cpu()).abs().max()) / max(
        1.0, float(ref.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("act", ACTS)
def test_gradient_flows_through_the_kernels(card, act):
    """First and second order (the penalty's shape) through the nested
    autograd on the card — forward with cs, backward with carries and
    adjoint kernels — against torch differentiating the plain forward
    twice on the CPU."""
    g = torch.Generator()
    g.manual_seed(1)
    xz0 = 0.5 * torch.randn(48, 32, 400, generator=g)
    rec0 = 0.1 * torch.randn(100, 400, generator=g)
    tgt = torch.randn(48, 32, 100, generator=g)

    def grads(fn, dev):
        xz = xz0.to(dev).requires_grad_(True)
        rec = rec0.to(dev).requires_grad_(True)
        gx, = torch.autograd.grad((fn(xz, rec, act) * tgt.to(dev)).sum(), xz,
                                  create_graph=True)
        return (gx,) + torch.autograd.grad((gx ** 2).sum(), (xz, rec))

    before = cuda_lstm.launch_counts()
    got = grads(cuda_lstm.lstm_seq, card)
    after = cuda_lstm.launch_counts()
    assert after["lstm_fwd_cs"] > before["lstm_fwd_cs"]
    assert after["lstm_bwd"] > before["lstm_bwd"] and after["lstm_adj"] > before["lstm_adj"]
    ref = grads(cuda_lstm.lstm_seq_plain, "cpu")
    for a, r in zip(got, ref):
        assert _scaled(a.detach(), r.detach()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_backward_and_adjoint_kernels_match_plain_on_card(card, dtype, bar):
    g = torch.Generator(device=card)
    g.manual_seed(2)
    rnd = lambda *shape: 0.3 * torch.randn(shape, device=card, generator=g)  # noqa: E731
    for w, b in ((48, 32), (168, 64)):
        xz = rnd(w, b, 400).to(dtype)
        rec = (rnd(100, 400) / 3).to(dtype)
        dhs, dcs, u, v = rnd(w, b, 100), rnd(w, b, 100), rnd(w, b, 400), rnd(100, 400)
        for act in ACTS:
            with torch.no_grad():
                hs, cs = cuda_lstm.lstm_fwd_cuda(xz, rec, act, with_cs=True)
                for dcs_, carries in ((None, False), (dcs, False), (None, True)):
                    before = cuda_lstm.launches_bwd
                    got = cuda_lstm.lstm_bwd(xz, rec, hs, cs, dhs, dcs_, act, carries)
                    assert cuda_lstm.launches_bwd == before + 1
                    ref = cuda_lstm.lstm_bwd_plain(xz, rec, hs, cs, dhs, dcs_, act, carries)
                    assert all(_scaled(a, r) <= bar for a, r in zip(got, ref))
                _, _, dhT, dcT = cuda_lstm.lstm_bwd_cuda(xz, rec, hs, cs, dhs, None, act, True)
                before = cuda_lstm.launches_adj
                got = cuda_lstm.lstm_adj(xz, rec, hs, cs, dhT, dcT, u, v, act)
                assert cuda_lstm.launches_adj == before + 1
                ref = cuda_lstm.lstm_adj_plain(xz, rec, hs, cs, dhT, dcT, u, v, act)
                assert all(_scaled(a, r) <= bar for a, r in zip(got, ref))


def _stack_case(card, dtype, w, b, seed):
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    rnd = lambda *shape: 0.3 * torch.randn(shape, device=card, generator=g)  # noqa: E731
    weights = (rnd(w, b, 400).to(dtype), (rnd(100, 400) / 3).to(dtype),
               (rnd(100, 400) / 3).to(dtype), rnd(400).to(dtype),
               (rnd(100, 400) / 3).to(dtype))
    return weights, rnd


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_stack_kernels_match_plain_on_card(card, dtype, bar):
    """Kernels 4 (primal, with_res), 5 (plain, directs, with_carries) and 6
    against their plain versions, each launch counted once."""
    for w, b in ((48, 32), (168, 64)):
        weights, rnd = _stack_case(card, dtype, w, b, w + b)
        dhs2, directs = rnd(w, b, 100), (rnd(w, b, 100), rnd(w, b, 100), rnd(w, b, 100))
        cots = (rnd(w, b, 400), rnd(100, 400), rnd(100, 400), rnd(400), rnd(100, 400))
        for act in ACTS:
            with torch.no_grad():
                for with_res, key in ((False, "stack_fwd"), (True, "stack_fwd_res")):
                    before = cuda_lstm.launch_counts()[key]
                    got = cuda_lstm_stack.stack_fwd(*weights, act, with_res)
                    assert cuda_lstm.launch_counts()[key] == before + 1
                    ref = cuda_lstm_stack.stack_seq_plain(*weights, act, with_res)
                    pairs = zip(got, ref) if with_res else [(got, ref)]
                    assert all(_scaled(a, r) <= bar for a, r in pairs)
                res = cuda_lstm_stack.stack_fwd_cuda(*weights, act, with_res=True)
                for d, carries in ((None, False), (directs, False), (None, True)):
                    before = cuda_lstm.launches_stack_bwd
                    got = cuda_lstm_stack.stack_bwd(*weights, *res, dhs2, d, act, carries)
                    assert cuda_lstm.launches_stack_bwd == before + 1
                    ref = cuda_lstm_stack.stack_bwd_plain(*weights, *res, dhs2, d, act,
                                                          carries)
                    assert len(got) == len(ref)
                    errs = [_scaled(a, r) for a, r in zip(got, ref)]
                    assert max(errs) <= bar, (w, b, act, d is not None, carries, errs)
                carries = cuda_lstm_stack.stack_bwd_cuda(*weights, *res, dhs2, None, act,
                                                         True)[5:]
                before = cuda_lstm.launches_stack_adj
                got = cuda_lstm_stack.stack_adj(*weights, *res, *carries, *cots, act)
                assert cuda_lstm.launches_stack_adj == before + 1
                ref = cuda_lstm_stack.stack_adj_plain(*weights, *res, *carries, *cots, act)
                errs = [_scaled(a, r) for a, r in zip(got, ref)]
                assert max(errs) <= bar, (w, b, act, errs)


@pytest.mark.gpu
def test_stack_wrappers_refuse_mixed_devices_and_grad(card):
    weights, _ = _stack_case(card, torch.float32, 4, 2, 0)
    xz1, rec1, k2, b2, rec2 = weights
    with pytest.raises(ValueError, match="k2 on cpu"):
        cuda_lstm_stack.stack_fwd_cuda(xz1, rec1, k2.cpu(), b2, rec2, "tanh")
    with pytest.raises(NotImplementedError, match="not differentiable"):
        cuda_lstm_stack.stack_fwd_cuda(xz1, rec1, k2, b2.requires_grad_(True), rec2, "tanh")
    seq = torch.zeros(4, 2, 100, device=card)
    with pytest.raises(ValueError, match="hs2 on cpu"):
        cuda_lstm_stack.stack_bwd_cuda(xz1, rec1, k2, b2.detach(), rec2, seq, seq,
                                       seq.cpu(), seq, seq)


#: LSTM launches per MTSS-WGAN-GP epoch (batch 32, n_critic 5) on each
#: critic route: the generator's single-layer kernels, and the critic's
#: fused stack or its two chained layers
EPOCH_LAUNCHES = {
    "auto": {"lstm_fwd": 2, "lstm_fwd_cs": 2, "lstm_bwd": 2, "lstm_adj": 0,
             "stack_fwd": 0, "stack_fwd_res": 11, "stack_bwd": 16, "stack_adj": 5},
    "chained": {"lstm_fwd": 2, "lstm_fwd_cs": 24, "lstm_bwd": 34, "lstm_adj": 10,
                "stack_fwd": 0, "stack_fwd_res": 0, "stack_bwd": 0, "stack_adj": 0},
}


@pytest.mark.gpu
@pytest.mark.parametrize("stack", ["auto", "chained"])
def test_epoch_on_card_matches_cpu_plain_path(card, stack):
    """One full-width MTSS-WGAN-GP epoch (W=48, H=100, batch 32,
    n_critic 5) on the card and, from a copy of the same state with the
    same draws, through the plain path on the CPU, on each critic route."""
    cfg = get_preset("mtss_wgan_gp")
    tcfg = dataclasses.replace(cfg.train, batch_size=32, n_critic=5, steps_per_call=1)
    g = torch.Generator(device=card)
    g.manual_seed(3)
    dataset = torch.rand((1000, cfg.model.window, cfg.model.features), generator=g,
                         device=card)
    pair = build_gan(cfg.model, device=card)
    state = init_gan_state(0, cfg.model, device=card)
    state.discriminator.stack = stack
    cpu_state = state.to("cpu")
    draws = sample_draws(g, pair, tcfg, dataset)
    cuda_lstm.reset_launches()
    state, m = make_train_step(pair, tcfg, dataset)(state, draws)
    assert cuda_lstm.launch_counts() == EPOCH_LAUNCHES[stack]
    cpu_draws = Draws(draws.idx.cpu(), draws.noises.cpu(), draws.alphas.cpu())
    cpu_state, mc = make_train_step(build_gan(cfg.model, device="cpu"), tcfg,
                                    dataset.cpu())(cpu_state, cpu_draws)
    for k in ("d_loss", "g_loss"):
        torch.testing.assert_close(m[k].cpu(), mc[k], rtol=1e-4, atol=0)
    for mod, ref in ((state.generator, cpu_state.generator),
                     (state.discriminator, cpu_state.discriminator)):
        for a, r in zip(mod.parameters(), ref.parameters()):
            torch.testing.assert_close(a.detach().cpu(), r.detach(), rtol=1e-4, atol=1e-5)


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
