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
adjoint) against their plain versions at the same scaled bars, and the
single-layer kernels' carry modes the same way.  The forward kernel's
four modes in both its layouts (registers at H=100 with up to two batch
rows a block; wide at H=120 f32 and H=160 bf16), the backward's modes
in both its layouts (registers at H=100 and H=37; wide at H=117 f32 and
H=160 bf16), the adjoint's two modes in both its layouts (the same
widths), and the stack forward's, backward's and adjoint's modes in
both their layouts (cluster at H=100 and H=37; wide at H=117 f32 and
H=160 bf16), each mode bit-equal over two launches.  The weight sums
alone against their plain version in float64 (scaled 1e-4), bit-equal
over two launches, a zero head giving the bits of no head.  One
training epoch on the card against the same epoch on the CPU plain path,
on the fused and the chained critic route: the JAX package's bar for its
kernel-vs-scan epoch.  The replication engine's lane sweep on the card
against the CPU from the same draws (losses rtol 1e-4, params atol 1e-5
+ rtol 1e-4, stop epochs equal; the evaluation's fit metrics rtol 1e-4,
its pseudo-inverse outputs 1e-3 scaled), and its chunked drive with the
stop flag read one chunk behind bit-equal to the serial drive.
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
from hfrep_tpu_torch.serve.fixture import (fixture_gen_model, fixture_server,
                                           init_ae_model)
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


#: the forward's four modes: (with_cs, carried, counter)
FWD_MODES = [(False, False, "lstm_fwd"), (True, False, "lstm_fwd_cs"),
             (False, True, "lstm_fwd_carry"), (True, True, "lstm_fwd_cs_carry")]


def _fwd_case(card, dtype, w, b, h, seed):
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    xz = (0.5 * torch.randn(w, b, 4 * h, device=card, generator=g)).to(dtype)
    rec = (torch.randn(h, 4 * h, device=card, generator=g) / h ** 0.5).to(dtype)
    carry = (0.5 * torch.randn(b, h, device=card, generator=g),
             0.5 * torch.randn(b, h, device=card, generator=g))
    return xz, rec, carry


def _fwd_modes_hold(card, dtype, w, b, h, seed):
    """Each mode of the forward kernel against its plain version, every
    activation, each launch counted once on its own counter.  Bars: the
    primal abs f32 2e-5 / bf16 1e-2; the other modes scaled by
    max(1, max|plain|), f32 1e-4 / bf16 1e-2."""
    xz, rec, carry = _fwd_case(card, dtype, w, b, h, seed)
    f32 = dtype == torch.float32
    for act in ACTS:
        for with_cs, carried, key in FWD_MODES:
            c = carry if carried else None
            with torch.no_grad():
                before = cuda_lstm.launch_counts()[key]
                got = cuda_lstm.lstm_fwd(xz, rec, act, with_cs, c)
                assert cuda_lstm.launch_counts()[key] == before + 1
                ref = cuda_lstm.lstm_seq_plain(xz, rec, act, with_cs, c)
            torch.cuda.synchronize()
            if key == "lstm_fwd":
                err, bar = float((got - ref).abs().max()), 2e-5 if f32 else 1e-2
            else:
                err, bar = max(_scaled(a, r) for a, r in zip(got, ref)), 1e-4 if f32 else 1e-2
            assert err <= bar, (w, b, h, act, key, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [48, 168])
def test_forward_register_layout_matches_plain_on_card(card, dtype, w):
    """The register layout (H=100, every preset width) in all four modes;
    B=133 gives two batch rows a block."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b in (8, 32, 64, 133):
        layout, _, rows = cuda_lstm.fwd_layout(100, dtype, b, sms,
                                               cuda_lstm._lib().hfrep_max_smem_optin(0))
        assert layout == "registers" and rows == -(-b // sms)
        _fwd_modes_hold(card, dtype, w, b, 100, seed=w + b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,h", [(torch.float32, 120), (torch.bfloat16, 160)])
def test_forward_wide_layout_matches_plain_on_card(card, dtype, h):
    """Widths the register file cannot hold run the wide layout, in all
    four modes."""
    for b in (8, 133):
        assert cuda_lstm.fwd_layout(
            h, dtype, b, torch.cuda.get_device_properties(0).multi_processor_count,
            cuda_lstm._lib().hfrep_max_smem_optin(0))[0] == "wide"
        _fwd_modes_hold(card, dtype, 48, b, h, seed=h + b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,h", [(torch.float32, 100), (torch.bfloat16, 100),
                                     (torch.float32, 120)])
def test_forward_launches_are_bitwise_repeatable(card, dtype, h):
    """Two launches on the same inputs give the same bits in every mode:
    the quad's sums run in one fixed order and nothing is atomic."""
    xz, rec, carry = _fwd_case(card, dtype, 48, 133, h, seed=11)
    for with_cs, carried, _ in FWD_MODES:
        with torch.no_grad():
            one = cuda_lstm.lstm_fwd_cuda(xz, rec, "tanh", with_cs, carry if carried else None)
            two = cuda_lstm.lstm_fwd_cuda(xz, rec, "tanh", with_cs, carry if carried else None)
        one, two = (one, two) if isinstance(one, tuple) else ((one,), (two,))
        assert all(torch.equal(a, b) for a, b in zip(one, two))


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


#: the backward's modes: (dcs, with_carries, carry0)
BWD_MODES = [(False, False, False), (True, False, False), (False, True, False),
             (False, False, True), (True, True, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,h,layout", [(torch.float32, 100, "registers"),
                                            (torch.bfloat16, 100, "registers"),
                                            (torch.float32, 37, "registers"),
                                            (torch.bfloat16, 37, "registers"),
                                            (torch.float32, 117, "wide"),
                                            (torch.bfloat16, 160, "wide")])
def test_backward_layouts_match_plain_on_card(card, dtype, h, layout):
    """The single-layer backward in the layout its launch rule picks (the
    register layout at H <= 100 — its gate-recompute pre-pass and quad
    sweep; at H=37 a part-filled last chunk — the wide one above) in its
    modes (plain, dcs, with_carries, carry0 with dc_fin, and all three
    together), every activation, W in {1, 2, 48, 168}, B in {1, 8, 32, 64,
    133}, on the forward kernel's residuals: within the scaled bars f32
    1e-4 / bf16 1e-2 of ``lstm_bwd_plain``; two launches bit-equal; each
    launch counted once, with its weight sum."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    limit = cuda_lstm._lib().hfrep_max_smem_optin(0)
    bar = 1e-4 if dtype == torch.float32 else 1e-2
    for w in (1, 2, 48, 168):
        for b in (1, 8, 32, 64, 133):
            assert cuda_lstm.bwd_layout(h, dtype, b, sms, limit)[0] == layout
            g = torch.Generator(device=card)
            g.manual_seed(w * b + h)
            rnd = lambda *s: torch.randn(s, device=card, generator=g)  # noqa: E731
            xz = (0.3 * rnd(w, b, 4 * h)).to(dtype)
            rec = (0.5 * rnd(h, 4 * h) / h ** 0.5).to(dtype)
            carry = (0.5 * rnd(b, h), 0.5 * rnd(b, h))
            dhs, dcs, dc_fin = 0.3 * rnd(w, b, h), 0.3 * rnd(w, b, h), 0.3 * rnd(b, h)
            for act in ACTS:
                with torch.no_grad():
                    for with_dcs, carries, carried in BWD_MODES:
                        c = carry if carried else None
                        hs, cs = cuda_lstm.lstm_fwd_cuda(xz, rec, act, True, c)
                        args = (xz, rec, hs, cs, dhs, dcs if with_dcs else None, act, carries,
                                c, dc_fin if carried else None)
                        key = "lstm_bwd_carry" if carried else "lstm_bwd"
                        before = (cuda_lstm.launch_counts()[key],
                                  cuda_lstm.weight_sum_launches()[(1, 1, False)])
                        got = cuda_lstm.lstm_bwd(*args)
                        assert (cuda_lstm.launch_counts()[key],
                                cuda_lstm.weight_sum_launches()[(1, 1, False)]) == (
                                    before[0] + 1, before[1] + 1)
                        again = cuda_lstm.lstm_bwd(*args)
                        ref = cuda_lstm.lstm_bwd_plain(*args)
                        torch.cuda.synchronize()
                        assert len(got) == len(ref)
                        assert all(torch.equal(x, y) for x, y in zip(got, again))
                        errs = [_scaled(x, r) for x, r in zip(got, ref)]
                        assert max(errs) <= bar, (w, b, act, with_dcs, carries, carried, errs)


#: the adjoint's modes: (carry, mu0)
ADJ_MODES = [(False, False), (True, True), (True, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,h,layout", [(torch.float32, 100, "registers"),
                                            (torch.bfloat16, 100, "registers"),
                                            (torch.float32, 37, "registers"),
                                            (torch.bfloat16, 37, "registers"),
                                            (torch.float32, 117, "wide"),
                                            (torch.bfloat16, 160, "wide")])
def test_adjoint_layouts_match_plain_on_card(card, dtype, h, layout):
    """The single-layer adjoint in the layout its launch rule picks (the
    register layout at H <= 100 — its gates and v-product pre-pass, quad
    sweep and transposed post-pass; at H=37 a part-filled last quarter —
    the wide one above) in both modes (carry-free; the carry mode from a
    nonzero carry with mu0, and with a null mu0), every activation, W in
    {1, 2, 48, 168}, B in {1, 8, 32, 64, 133}, on the forward kernel's
    residuals and the backward kernel's carries: within the scaled bars
    f32 1e-4 / bf16 1e-2 of ``lstm_adj_plain``; two launches bit-equal;
    each launch counted once, with its two-pair weight sum."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    limit = cuda_lstm._lib().hfrep_max_smem_optin(0)
    bar = 1e-4 if dtype == torch.float32 else 1e-2
    for w in (1, 2, 48, 168):
        for b in (1, 8, 32, 64, 133):
            assert cuda_lstm.adj_layout(h, dtype, b, sms, limit)[0] == layout
            g = torch.Generator(device=card)
            g.manual_seed(w * b + h + 1)
            rnd = lambda *s: torch.randn(s, device=card, generator=g)  # noqa: E731
            xz = (0.3 * rnd(w, b, 4 * h)).to(dtype)
            rec = (0.5 * rnd(h, 4 * h) / h ** 0.5).to(dtype)
            carry = (0.5 * rnd(b, h), 0.5 * rnd(b, h))
            dhs, dc_fin = 0.3 * rnd(w, b, h), 0.3 * rnd(b, h)
            u, v = 0.3 * rnd(w, b, 4 * h), 0.3 * rnd(h, 4 * h)
            mu0 = (0.3 * rnd(b, h), 0.3 * rnd(b, h))
            for act in ACTS:
                with torch.no_grad():
                    for carried, with_mu in ADJ_MODES:
                        c = carry if carried else None
                        hs, cs = cuda_lstm.lstm_fwd_cuda(xz, rec, act, True, c)
                        dhT, dcT = cuda_lstm.lstm_bwd_cuda(
                            xz, rec, hs, cs, dhs, None, act, True, c,
                            dc_fin if carried else None)[2:4]
                        args = (xz, rec, hs, cs, dhT, dcT, u, v, act, c, mu0 if with_mu else None)
                        key = "lstm_adj_carry" if carried else "lstm_adj"
                        before = (cuda_lstm.launch_counts()[key],
                                  cuda_lstm.weight_sum_launches()[(1, 2, False)])
                        got = cuda_lstm.lstm_adj(*args)
                        assert (cuda_lstm.launch_counts()[key],
                                cuda_lstm.weight_sum_launches()[(1, 2, False)]) == (
                                    before[0] + 1, before[1] + 1)
                        again = cuda_lstm.lstm_adj(*args)
                        ref = cuda_lstm.lstm_adj_plain(*args)
                        torch.cuda.synchronize()
                        assert len(got) == len(ref) == (8 if carried else 5)
                        assert all(torch.equal(x, y) for x, y in zip(got, again))
                        errs = [_scaled(x, r) for x, r in zip(got, ref)]
                        assert max(errs) <= bar, (w, b, act, carried, with_mu, errs)


@pytest.mark.gpu
@pytest.mark.parametrize("npair", [1, 2])
def test_weight_sums_match_plain_on_card(card, npair):
    """The weight sums alone (``csrc/weight_sum.cu``) against
    ``weight_sum_plain`` in float64 at W in {1, 48, 168} x B in {1, 32, 64,
    133} rows, M in {100, 1} (the column sum), one sum and three, with and
    without heads, the rule's cluster size and each forced one: scaled
    error within 1e-4 (sums of up to 2 x 22,344 rows in another order); two
    launches bit-equal; a zero head gives the bits of no head; the C++
    split rule is ``sum_splits``; each launch counted once."""
    g = torch.Generator(device=card)
    g.manual_seed(npair)
    rnd = lambda *s: torch.randn(s, device=card, generator=g)  # noqa: E731
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = cuda_lstm._lib("weight_sum")
    for w in (1, 48, 168):
        for b in (1, 32, 64, 133):
            r = w * b
            for m, nsum, heads in ((100, 1, False), (100, 1, True), (100, 3, True),
                                   (1, 1, False)):
                sums = [([(None if m == 1 else rnd(r, m), rnd(r, 400),
                           rnd(b, m) if heads else None) for _ in range(npair)], b)
                        for _ in range(nsum)]
                refs = [cuda_lstm.weight_sum_plain(
                    [(None if a is None else a.double(), bb.double(),
                      None if h is None else h.double()) for a, bb, h in t], s)
                        for t, s in sums]
                shape = (nsum, npair, m == 1)
                for splits in (0, 1, 2, 4, 8, 16):
                    before = cuda_lstm.weight_sum_launches()
                    got = cuda_lstm.weight_sums_cuda(sums, splits)
                    after = cuda_lstm.weight_sum_launches()
                    assert {k: after[k] - before[k] for k in after} == {
                        k: int(k == shape) for k in after}
                    again = cuda_lstm.weight_sums_cuda(sums, splits)
                    torch.cuda.synchronize()
                    for x, y, ref in zip(got, again, refs):
                        assert torch.equal(x, y)
                        assert _scaled(x.double(), ref) <= 1e-4, (w, b, m, nsum, heads, splits)
                if heads:
                    zero = [([(a, bb, torch.zeros_like(h)) for a, bb, h in t], s) for t, s in sums]
                    none = [([(a, bb, None) for a, bb, _ in t], s) for t, s in sums]
                    assert all(torch.equal(x, y) for x, y in zip(
                        cuda_lstm.weight_sums_cuda(zero), cuda_lstm.weight_sums_cuda(none)))
                assert (lib.hfrep_weight_sum_splits(nsum, npair, r, m, 400, sms)
                        == cuda_lstm.sum_plan(nsum, npair, r, m, 400, sms)[2])


def _carry_case(card, dtype, w, b, seed):
    """Operands, a nonzero carry (scale 0.5), the forward's residuals from
    the carry kernel and seeded cotangents."""
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    rnd = lambda *shape: 0.3 * torch.randn(shape, device=card, generator=g)  # noqa: E731
    xz, rec = rnd(w, b, 400).to(dtype), (rnd(100, 400) / 3).to(dtype)
    carry = (rnd(b, 100) * 5 / 3, rnd(b, 100) * 5 / 3)
    cots = dict(dhs=rnd(w, b, 100), dcs=rnd(w, b, 100), dc_fin=rnd(b, 100),
                u=rnd(w, b, 400), v=rnd(100, 400), mu0=(rnd(b, 100), rnd(b, 100)))
    return xz, rec, carry, cots


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_carry_kernels_match_plain_on_card(card, dtype, bar):
    """Each carry mode of kernels 1–3 against its plain version from a
    nonzero (h0, c0), with dc_fin and mu0, each launch counted once on its
    own counter."""
    for w, b in ((48, 32), (168, 64)):
        xz, rec, carry, c = _carry_case(card, dtype, w, b, w + b)
        for act in ACTS:
            with torch.no_grad():
                for with_cs, key in ((False, "lstm_fwd_carry"), (True, "lstm_fwd_cs_carry")):
                    before = cuda_lstm.launch_counts()[key]
                    got = cuda_lstm.lstm_fwd(xz, rec, act, with_cs, carry)
                    assert cuda_lstm.launch_counts()[key] == before + 1
                    ref = cuda_lstm.lstm_seq_plain(xz, rec, act, with_cs, carry)
                    assert max(_scaled(a, r) for a, r in zip(got, ref)) <= bar
                hs, cs = cuda_lstm.lstm_fwd_cuda(xz, rec, act, True, carry)
                for dcs, carries in ((None, True), (c["dcs"], False)):
                    before = cuda_lstm.launches_bwd_carry
                    got = cuda_lstm.lstm_bwd(xz, rec, hs, cs, c["dhs"], dcs, act, carries,
                                             carry, c["dc_fin"])
                    assert cuda_lstm.launches_bwd_carry == before + 1
                    ref = cuda_lstm.lstm_bwd_plain(xz, rec, hs, cs, c["dhs"], dcs, act,
                                                   carries, carry, c["dc_fin"])
                    assert len(got) == len(ref) == (6 if carries else 4)
                    errs = [_scaled(a, r) for a, r in zip(got, ref)]
                    assert max(errs) <= bar, (w, b, act, carries, errs)
                _, _, dhT, dcT, _, _ = cuda_lstm.lstm_bwd_cuda(
                    xz, rec, hs, cs, c["dhs"], None, act, True, carry, c["dc_fin"])
                before = cuda_lstm.launches_adj_carry
                got = cuda_lstm.lstm_adj(xz, rec, hs, cs, dhT, dcT, c["u"], c["v"], act,
                                         carry, c["mu0"])
                assert cuda_lstm.launches_adj_carry == before + 1
                ref = cuda_lstm.lstm_adj_plain(xz, rec, hs, cs, dhT, dcT, c["u"], c["v"], act,
                                               carry, c["mu0"])
                errs = [_scaled(a, r) for a, r in zip(got, ref)]
                assert len(errs) == 8 and max(errs) <= bar, (w, b, act, errs)


@pytest.mark.gpu
def test_carry_wrappers_refuse_mixed_devices_and_bad_carries(card):
    xz, rec, (h0, c0), c = _carry_case(card, torch.float32, 4, 2, 0)
    with pytest.raises(ValueError, match="h0 on cpu"):
        cuda_lstm.lstm_fwd_cuda(xz, rec, "tanh", carry=(h0.cpu(), c0))
    with pytest.raises(TypeError, match="c0 must be float32"):
        cuda_lstm.lstm_fwd_cuda(xz, rec, "tanh", carry=(h0, c0.to(torch.bfloat16)))
    with pytest.raises(ValueError, match="want h0"):
        cuda_lstm.lstm_fwd_cuda(xz, rec, "tanh", carry=(h0[:1], c0))
    hs, cs = cuda_lstm.lstm_fwd_cuda(xz, rec, "tanh", True, (h0, c0))
    with pytest.raises(ValueError, match="dc_fin on cpu"):
        cuda_lstm.lstm_bwd_cuda(xz, rec, hs, cs, c["dhs"], carry=(h0, c0),
                                dc_fin=c["dc_fin"].cpu())
    with pytest.raises(ValueError, match="want c0"):
        cuda_lstm.lstm_bwd_cuda(xz, rec, hs, cs, c["dhs"], carry=(h0, c0.T.contiguous()))
    with pytest.raises(TypeError, match="muh0 must be float32"):
        cuda_lstm.lstm_adj_cuda(xz, rec, hs, cs, hs, cs, c["u"], c["v"], carry=(h0, c0),
                                mu0=(c["mu0"][0].double(), None))
    with pytest.raises(NotImplementedError, match="not differentiable"):
        cuda_lstm.lstm_fwd_cuda(xz, rec, "tanh", carry=(h0.requires_grad_(True), c0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_carry_equals_carry_free_kernels_bitwise(card, dtype):
    """A zero (h0, c0, dc_fin, mu0) through the carry modes gives the
    carry-free kernels' results bit for bit: the reduction's head operand
    of zeros reads as the null head the carry-free calls (and the fused
    stack's) pass, and a zero state as the zero start."""
    xz, rec, (h0, _), c = _carry_case(card, dtype, 48, 32, 7)
    z = (torch.zeros_like(h0), torch.zeros_like(h0))
    for act in ACTS:
        with torch.no_grad():
            hs, cs = cuda_lstm.lstm_fwd_cuda(xz, rec, act, True)
            got = cuda_lstm.lstm_fwd_cuda(xz, rec, act, True, z)
            assert torch.equal(got[0], hs) and torch.equal(got[1], cs)
            assert torch.equal(cuda_lstm.lstm_fwd_cuda(xz, rec, act, carry=z)[0],
                               cuda_lstm.lstm_fwd_cuda(xz, rec, act))
            for dcs, carries in ((None, False), (c["dcs"], False), (None, True)):
                ref = cuda_lstm.lstm_bwd_cuda(xz, rec, hs, cs, c["dhs"], dcs, act, carries)
                got = cuda_lstm.lstm_bwd_cuda(xz, rec, hs, cs, c["dhs"], dcs, act, carries,
                                              z, z[0])
                assert all(torch.equal(a, r) for a, r in zip(got, ref))
            _, _, dhT, dcT = cuda_lstm.lstm_bwd_cuda(xz, rec, hs, cs, c["dhs"], None, act, True)
            ref = cuda_lstm.lstm_adj_cuda(xz, rec, hs, cs, dhT, dcT, c["u"], c["v"], act)
            got = cuda_lstm.lstm_adj_cuda(xz, rec, hs, cs, dhT, dcT, c["u"], c["v"], act, z, z)
            assert all(torch.equal(a, r) for a, r in zip(got, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["sigmoid", "tanh"])
def test_carry_chunks_through_the_kernels_match_plain(card, act):
    """Four chunks of 12 passing (h, c) through ``lstm_seq_carry`` on the
    card, first order and the ``gp_like`` second order, against the
    whole window through the plain carry forward differentiated twice by
    torch on the CPU; only the carry kernels launch."""
    g = torch.Generator()
    g.manual_seed(9)
    base = [0.3 * torch.randn(48, 32, 400, generator=g), 0.1 * torch.randn(100, 400, generator=g),
            0.5 * torch.randn(32, 100, generator=g), 0.5 * torch.randn(32, 100, generator=g)]

    def gp_like(dev, chunked):
        args = [t.to(dev).requires_grad_(True) for t in base]
        xz, rec, h0, c0 = args
        if chunked:
            hs, h, c = [], h0, c0
            for k in range(0, 48, 12):
                hs_k, c = cuda_lstm.lstm_seq_carry(xz[k:k + 12], rec, h, c, act)
                hs.append(hs_k)
                h = hs_k[-1]
            hs = torch.cat(hs)
        else:
            hs, c = cuda_lstm.lstm_seq_plain(xz, rec, act, carry=(h0, c0))
        gr = torch.autograd.grad(hs.sum() + c.sum(), (xz, h0, c0), create_graph=True)
        pen = (1.0 - torch.sqrt(sum((t ** 2).sum() for t in gr) + 1e-12)) ** 2
        return gr + torch.autograd.grad(pen, args)

    cuda_lstm.reset_launches()
    got = gp_like(card, True)
    launched = {k for k, n in cuda_lstm.launch_counts().items() if n}
    assert launched == {"lstm_fwd_cs_carry", "lstm_bwd_carry", "lstm_adj_carry"}
    ref = gp_like("cpu", False)
    for a, r in zip(got, ref):
        assert _scaled(a.detach(), r.detach()) <= 1e-4


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


def _stack_fwd_case(card, dtype, w, b, h, seed):
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    mat = lambda: (0.5 * torch.randn(h, 4 * h, device=card, generator=g) / h ** 0.5).to(dtype)  # noqa: E731
    return ((0.3 * torch.randn(w, b, 4 * h, device=card, generator=g)).to(dtype), mat(), mat(),
            (0.3 * torch.randn(4 * h, device=card, generator=g)).to(dtype), mat())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,h,layout", [(torch.float32, 100, "cluster"),
                                            (torch.bfloat16, 100, "cluster"),
                                            (torch.float32, 117, "wide"),
                                            (torch.bfloat16, 160, "wide")])
def test_stack_forward_layouts_match_plain_on_card(card, dtype, h, layout):
    """The stack forward in the layout its launch rule picks (the cluster
    at H=100, the wide one above), both modes, every activation, W in {1,
    2, 48, 168}, B in {1, 8, 32, 64, 133}; bars: the primal abs f32 2e-5 /
    bf16 1e-2, with_res scaled f32 1e-4 / bf16 1e-2; two launches
    bit-equal; each launch counted once."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    limit = cuda_lstm._lib().hfrep_max_smem_optin(0)
    f32 = dtype == torch.float32
    for w in (1, 2, 48, 168):
        for b in (1, 8, 32, 64, 133):
            assert cuda_lstm_stack.stack_fwd_layout(h, dtype, b, sms, limit)[0] == layout
            weights = _stack_fwd_case(card, dtype, w, b, h, seed=w * b + h)
            for act in ACTS:
                for with_res, key in ((False, "stack_fwd"), (True, "stack_fwd_res")):
                    with torch.no_grad():
                        before = cuda_lstm.launch_counts()[key]
                        got = cuda_lstm_stack.stack_fwd(*weights, act, with_res)
                        assert cuda_lstm.launch_counts()[key] == before + 1
                        again = cuda_lstm_stack.stack_fwd(*weights, act, with_res)
                        ref = cuda_lstm_stack.stack_seq_plain(*weights, act, with_res)
                    torch.cuda.synchronize()
                    got, again, ref = ((x,) if torch.is_tensor(x) else x
                                       for x in (got, again, ref))
                    assert all(torch.equal(a, a2) for a, a2 in zip(got, again))
                    if with_res:
                        err, bar = max(_scaled(a, r) for a, r in zip(got, ref)), 1e-4 if f32 else 1e-2
                    else:
                        err, bar = float((got[0] - ref[0]).abs().max()), 2e-5 if f32 else 1e-2
                    assert err <= bar, (w, b, act, with_res, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,h,layout", [(torch.float32, 100, "cluster"),
                                            (torch.bfloat16, 100, "cluster"),
                                            (torch.float32, 37, "cluster"),
                                            (torch.bfloat16, 37, "cluster"),
                                            (torch.float32, 117, "wide"),
                                            (torch.bfloat16, 160, "wide")])
def test_stack_backward_layouts_match_plain_on_card(card, dtype, h, layout):
    """The stack backward in the layout its launch rule picks (the cluster
    at H <= 100 — at H=37 rows of unaligned length and a part-filled last
    chunk — the wide one above) in its three modes (plain, direct
    cotangents, with the carries), every activation, W in {1, 2, 48, 168},
    B in {1, 8, 32, 64, 133}, on the forward kernel's residuals: within the
    scaled bars f32 1e-4 / bf16 1e-2 of ``stack_bwd_plain``; two launches
    bit-equal; each launch counted once."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    limit = cuda_lstm._lib().hfrep_max_smem_optin(0)
    bar = 1e-4 if dtype == torch.float32 else 1e-2
    for w in (1, 2, 48, 168):
        for b in (1, 8, 32, 64, 133):
            assert cuda_lstm_stack.stack_bwd_layout(h, dtype, b, sms, limit)[0] == layout
            weights = _stack_fwd_case(card, dtype, w, b, h, seed=w * b + h + 1)
            g = torch.Generator(device=card)
            g.manual_seed(w + b)
            rnd = lambda: 0.3 * torch.randn((w, b, h), device=card, generator=g)  # noqa: E731
            dhs2, directs = rnd(), (rnd(), rnd(), rnd())
            for act in ACTS:
                with torch.no_grad():
                    res = cuda_lstm_stack.stack_fwd_cuda(*weights, act, with_res=True)
                    for d, carries in ((None, False), (directs, False), (None, True)):
                        before = cuda_lstm.launches_stack_bwd
                        got = cuda_lstm_stack.stack_bwd(*weights, *res, dhs2, d, act, carries)
                        assert cuda_lstm.launches_stack_bwd == before + 1
                        again = cuda_lstm_stack.stack_bwd(*weights, *res, dhs2, d, act, carries)
                        ref = cuda_lstm_stack.stack_bwd_plain(*weights, *res, dhs2, d, act,
                                                              carries)
                        torch.cuda.synchronize()
                        assert len(got) == len(ref) == (9 if carries else 5)
                        assert all(torch.equal(a, a2) for a, a2 in zip(got, again))
                        errs = [_scaled(a, r) for a, r in zip(got, ref)]
                        assert max(errs) <= bar, (w, b, act, d is not None, carries, errs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,h,layout", [(torch.float32, 100, "cluster"),
                                            (torch.bfloat16, 100, "cluster"),
                                            (torch.float32, 37, "cluster"),
                                            (torch.bfloat16, 37, "cluster"),
                                            (torch.float32, 117, "wide"),
                                            (torch.bfloat16, 160, "wide")])
def test_stack_adjoint_layouts_match_plain_on_card(card, dtype, h, layout):
    """The stack adjoint in the layout its launch rule picks (the cluster
    at H <= 100 — its pre-pass, two-block sweep and post-pass — the wide
    one above), every activation, W in {1, 2, 48, 168}, B in {1, 8, 32,
    64, 133}, on the forward kernel's residuals and the backward kernel's
    carries, with seeded cotangents: within the scaled bars f32 1e-4 /
    bf16 1e-2 of ``stack_adj_plain``; two launches bit-equal; each launch
    counted once; the same layout as the forward's and the backward's."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    limit = cuda_lstm._lib().hfrep_max_smem_optin(0)
    bar = 1e-4 if dtype == torch.float32 else 1e-2
    for w in (1, 2, 48, 168):
        for b in (1, 8, 32, 64, 133):
            plan = cuda_lstm_stack.stack_adj_layout(h, dtype, b, sms, limit)
            assert plan[0] == layout
            assert plan == cuda_lstm_stack.stack_bwd_layout(h, dtype, b, sms, limit)
            weights = _stack_fwd_case(card, dtype, w, b, h, seed=w * b + h + 2)
            g = torch.Generator(device=card)
            g.manual_seed(w + b + 1)
            rnd = lambda *shape: 0.3 * torch.randn(shape, device=card, generator=g)  # noqa: E731
            dhs2 = rnd(w, b, h)
            cots = (rnd(w, b, 4 * h), rnd(h, 4 * h), rnd(h, 4 * h), rnd(4 * h), rnd(h, 4 * h))
            for act in ACTS:
                with torch.no_grad():
                    res = cuda_lstm_stack.stack_fwd_cuda(*weights, act, with_res=True)
                    carries = cuda_lstm_stack.stack_bwd_cuda(*weights, *res, dhs2, None, act,
                                                             True)[5:]
                    before = cuda_lstm.launches_stack_adj
                    got = cuda_lstm_stack.stack_adj(*weights, *res, *carries, *cots, act)
                    assert cuda_lstm.launches_stack_adj == before + 1
                    again = cuda_lstm_stack.stack_adj(*weights, *res, *carries, *cots, act)
                    ref = cuda_lstm_stack.stack_adj_plain(*weights, *res, *carries, *cots, act)
                torch.cuda.synchronize()
                assert len(got) == len(ref) == 10
                assert all(torch.equal(a, a2) for a, a2 in zip(got, again))
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
for _counts in EPOCH_LAUNCHES.values():       # the epochs launch no carry mode
    _counts.update(lstm_fwd_carry=0, lstm_fwd_cs_carry=0, lstm_bwd_carry=0, lstm_adj_carry=0)
#: the weight sums' launches in that epoch, by (sums a launch, pairs, column
#: sum), as the C launcher counts them: lstm_bwd's drec, lstm_adj's urec,
#: stack_bwd's and stack_adj's three products and their bias sum; 44 each
EPOCH_SUM_LAUNCHES = {
    "auto": {(1, 1, False): 2, (3, 1, False): 16, (3, 2, False): 5, (1, 1, True): 21},
    "chained": {(1, 1, False): 34, (1, 2, False): 10},
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
    assert {k: n for k, n in cuda_lstm.weight_sum_launches().items() if n} == (
        EPOCH_SUM_LAUNCHES[stack])
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
    got = aot.gen_batch_fn(model)(model.params, noise.to(card)).cpu()
    assert cuda_lstm.launches == before + 2          # one launch per LSTM layer
    ref = aot.gen_batch_fn(cpu)(cpu.params, noise)
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.gpu
def test_server_on_card_runs_the_kernel(card):
    srv = fixture_server(ServeConfig(request_timeout_ms=60000.0), device=card,
                         ae_model=init_ae_model(device=card))
    try:
        srv.warm()
        cuda_lstm.reset_launches()
        report = drive_load(srv, 16, make_panels(0, 22, (24,)), sample_every=2,
                            timeout_ms=60000)
    finally:
        srv.stop()
    assert report["terminal"] == report["submitted"] == report["results"] == 16
    assert cuda_lstm.launches >= 2


def _sweep_inputs():
    from pathlib import Path

    from hfrep_tpu_torch.core import scaler
    from hfrep_tpu_torch.core.data import load_panel

    panel = load_panel(Path(__file__).resolve().parents[1] / "results" / "rederived_cleaned",
                       device="cpu")
    x_train, x_test, _, y_test = panel.train_test_split()
    return panel, scaler.fit_transform(x_train)[1], x_test, y_test


@pytest.mark.gpu
def test_lane_sweep_on_card_matches_cpu(card):
    import numpy as np

    from hfrep_tpu_torch.config import AEConfig
    from hfrep_tpu_torch.replication import engine

    panel, xs, x_test, y_test = _sweep_inputs()
    lats = [1, 7, 21]
    cfg = AEConfig(epochs=30, chunk_epochs=10, latent_dim=21)
    g = torch.Generator()
    g.manual_seed(3)
    init = engine.keras_init_params(g, (3,), 22, 21, "cpu")
    perms = engine.PermStream(5, (3,), 126, torch.device("cpu"))
    runs = {dev: engine.sweep_autoencoders_chunked(
        0, xs, cfg, lats, init_params=init, device=dev,
        perm_source=lambda pos, n: perms(pos, n).to(dev))[0] for dev in ("cpu", "cuda")}
    cpu, gpu = runs["cpu"], runs["cuda"]
    assert torch.equal(cpu.stop_epoch, gpu.stop_epoch.cpu())
    for k in cpu.params:
        torch.testing.assert_close(gpu.params[k].cpu(), cpu.params[k], atol=1e-5, rtol=1e-4)
    for k in ("train_loss", "val_loss"):
        torch.testing.assert_close(getattr(gpu, k).cpu(), getattr(cpu, k), atol=0, rtol=1e-4,
                                   equal_nan=True)
    masks = torch.stack([engine.latent_mask(d, 21, device="cpu") for d in lats])
    rf = panel.rf[168:]
    evs = {dev: engine.sweep_evaluate(cfg, xs.to(dev), x_test.to(dev), y_test.to(dev),
                                      rf.to(dev), panel.factors.to(dev),
                                      {k: v.to(dev) for k, v in cpu.params.items()},
                                      masks.to(dev)) for dev in ("cpu", "cuda")}
    for k, want in evs["cpu"].items():
        got = evs["cuda"][k].cpu()
        if k in ("ante", "post", "turnover", "sharpe_ante", "sharpe_post"):
            err = (got - want).abs().max() / max(1.0, float(want.abs().max()))
            assert float(err) < 1e-3, k
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)


@pytest.mark.gpu
def test_double_buffered_drive_on_card_is_bitwise_serial(card):
    from hfrep_tpu_torch.config import AEConfig
    from hfrep_tpu_torch.replication import engine

    _, xs, _, _ = _sweep_inputs()
    out = {}
    for db in (True, False):
        cfg = AEConfig(epochs=40, chunk_epochs=7, patience=2, lr=0.05, double_buffer=db)
        out[db] = engine.sweep_autoencoders_chunked(7, xs, cfg, [1, 3, 21], device="cuda")
    (a, sa), (b, sb) = out[True], out[False]
    assert sa.overshoot_chunks <= 1 and sb.overshoot_chunks == 0
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    assert torch.equal(a.stop_epoch, b.stop_epoch)
    assert torch.equal(a.val_loss.view(torch.int32), b.val_loss.view(torch.int32))


@pytest.mark.gpu
def test_penalty_training_is_the_same_first_and_later_in_a_process(card):
    """The WGAN-GP step's backwards run on the calling thread
    (``train/steps.py::_grad``): a process's first training equals its
    later ones bit for bit, the property a resume in a fresh process
    rests on (the chaos engine's ``gan_ckpt|0|sigterm@block=1``)."""
    import numpy as np

    from hfrep_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
    from hfrep_tpu_torch.train.trainer import GanTrainer

    cfg = ExperimentConfig(
        model=ModelConfig(features=4, window=8, hidden=100, family="mtss_wgan_gp"),
        train=TrainConfig(epochs=4, batch_size=4, n_critic=1, steps_per_call=2, seed=0))
    ds = torch.from_numpy(np.random.default_rng(2000).standard_normal((12, 8, 4))
                          .astype(np.float32))
    runs = []
    for _ in range(3):
        tr = GanTrainer(cfg, ds, device="cuda")
        tr.train()
        runs.append([t.detach().cpu() for m in (tr.state.generator, tr.state.discriminator)
                     for t in m.state_dict().values()])
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


@pytest.mark.gpu
def test_exported_generator_on_card_runs_the_kernel_bitwise(card):
    """A serve bucket's program through ``torch.export`` on the card: mode
    ``"export"``, its answer bit for bit the eager program's, and each of
    its two LSTM layers one counted ``lstm_fwd`` launch (the dispatcher
    op ``hfrep::lstm_fwd`` launches inside the loaded program)."""
    model = fixture_gen_model("mtss_wgan_gp_prod", device=card)
    g = torch.Generator(device=card)
    g.manual_seed(5)
    noise = torch.randn((8, model.cfg.window, model.cfg.features), generator=g, device=card)
    fn = aot.gen_batch_fn(model)
    with torch.inference_mode():
        eager = fn(model.params, noise)
    rt, mode = aot.aot_compile(fn, model.params, noise, via_export=True)
    assert mode == "export"
    cuda_lstm.reset_launches()
    got = rt(model.params, noise)
    torch.cuda.synchronize()
    assert cuda_lstm.launches == 2
    assert torch.equal(got, eager)


@pytest.mark.gpu
def test_bf16_fused_epoch_launches_the_bf16_instantiations(card):
    """One bf16 epoch of ``mtss_wgan_gp`` on the fused critic route: every
    recurrence kernel the profiler sees is an ``__nv_bfloat16``
    instantiation, and the kernels launched are the float32 route's."""
    from torch.profiler import ProfilerActivity, profile

    cfg = get_preset("mtss_wgan_gp")
    mcfg = dataclasses.replace(cfg.model, dtype="bfloat16")
    tcfg = dataclasses.replace(cfg.train, batch_size=32, n_critic=5, steps_per_call=1)
    g = torch.Generator(device=card)
    g.manual_seed(3)
    dataset = torch.rand((256, mcfg.window, mcfg.features), generator=g, device=card)
    pair = build_gan(mcfg, device=card)
    state = init_gan_state(0, mcfg, device=card)
    step = make_train_step(pair, tcfg, dataset)
    state, _ = step(state, sample_draws(g, pair, tcfg, dataset))     # builds the kernels
    torch.cuda.synchronize()
    cuda_lstm.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, m = step(state, sample_draws(g, pair, tcfg, dataset))
        torch.cuda.synchronize()
    launched = {k for k, v in cuda_lstm.launch_counts().items() if v}
    assert launched == {"lstm_fwd", "lstm_fwd_cs", "lstm_bwd", "stack_fwd_res", "stack_bwd",
                        "stack_adj"}
    names = [e.key for e in prof.key_averages()
             if ("lstm_" in e.key or "stack_" in e.key) and "_kernel" in e.key]
    assert names and all("__nv_bfloat16" in n for n in names), names
    assert torch.isfinite(m["d_loss"]) and m["d_loss"].dtype == torch.float32
