"""The port's LSTM derivatives (``hfrep_tpu_torch.ops.cuda_lstm``) against
the JAX package.

* The plain versions of the kernels — ``lstm_seq_plain(with_cs=True)``,
  ``lstm_bwd_plain`` (plain, ``dcs`` and ``with_carries`` modes) and
  ``lstm_adj_plain`` — against the Pallas kernels in interpret mode and
  against the scan twin (``_lstm_bwd_scan``, ``jax.vjp`` over it), at
  hp = 128 so the layouts coincide; the set-up of
  tests/test_pallas_lstm.py's adjoint test.  Bars atol 1e-5 (adjoint
  also rtol 1e-4; urec atol 1e-4, its W-step sum as the JAX suite allows).
* The nested autograd (``LSTMFwdRes`` / ``LSTMBwdSeq``) at first and
  second order against torch's own double backward over the plain
  forward: atol 1e-5, rtol 1e-4.
* The Keras entry against ``jax.grad`` through the JAX ``KerasLSTM``:
  first order (H in {16, 100}) and the penalty-shaped second order
  against JAX's XLA double backward, atol 1e-5, rtol 1e-4; bf16 operand
  streams against the float32 JAX gradients at the scaled 5e-2 bar.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfrep_tpu.ops.lstm import KerasLSTM as JaxKerasLSTM
from hfrep_tpu.ops.pallas_lstm import (_adj_call, _bwd_call, _lstm_bwd_scan,
                                       _lstm_seq_fwd_impl)
from hfrep_tpu_torch.ops import cuda_lstm
from hfrep_tpu_torch.ops.lstm import KerasLSTM
from hfrep_tpu_torch.utils.bridge import from_flax

ACTS = ["sigmoid", "tanh", "linear"]
W, B, HP = 5, 4, 128


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, ref, atol=1e-5, rtol=0.0, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol,
                               rtol=rtol, err_msg=name)


def _kernel_case(activation):
    """tests/test_pallas_lstm.py's adjoint set-up: w=5, b=4, hp=128."""
    ks = jax.random.split(jax.random.PRNGKey(7), 4)
    g = 4 * HP
    xz = 0.3 * jax.random.normal(ks[0], (W, B, g))
    rec = 0.3 * jax.random.normal(ks[1], (HP, g))
    dhs = 0.3 * jax.random.normal(ks[2], (W, B, HP))
    hs, cs = _lstm_seq_fwd_impl(xz, rec, activation, with_cs=True)
    u = 0.3 * jax.random.normal(ks[3], (W, B, g))
    v = 0.3 * jax.random.normal(ks[3], (HP, g))
    dcs = 0.3 * jax.random.normal(jax.random.fold_in(ks[2], 1), (W, B, HP))
    return dict(xz=xz, rec=rec, dhs=dhs, hs=hs, cs=cs, u=u, v=v, dcs=dcs)


@pytest.mark.parametrize("activation", ACTS)
def test_forward_with_cs_matches_pallas(activation):
    c = _kernel_case(activation)
    hs, cs = cuda_lstm.lstm_seq_plain(_t(c["xz"]), _t(c["rec"]), activation, with_cs=True)
    _close(hs, c["hs"], name="hs")
    _close(cs, c["cs"], name="cs")


@pytest.mark.parametrize("mode", ["plain", "dcs", "with_carries"])
@pytest.mark.parametrize("activation", ACTS)
def test_bwd_plain_matches_pallas_and_scan(activation, mode):
    c = _kernel_case(activation)
    dcs = c["dcs"] if mode == "dcs" else None
    carries = mode == "with_carries"
    ref = _bwd_call(c["xz"], c["rec"], c["hs"], c["cs"], c["dhs"], dcs, activation,
                    with_carries=carries)
    twin = _lstm_bwd_scan(c["xz"], c["rec"], c["hs"], c["cs"], c["dhs"], dcs, activation)
    got = cuda_lstm.lstm_bwd_plain(*(_t(c[k]) for k in ("xz", "rec", "hs", "cs", "dhs")),
                                   None if dcs is None else _t(dcs), activation,
                                   with_carries=carries)
    assert len(got) == len(ref) == (4 if carries else 2)
    for name, a, r in zip(("dxz", "drec", "dhT", "dcT"), got, ref):
        _close(a, r, name=f"{name} vs pallas")
    for name, a, r in zip(("dxz", "drec"), got, twin):
        _close(a, r, name=f"{name} vs scan twin")


@pytest.mark.parametrize("activation", ACTS)
def test_adj_plain_matches_pallas_and_scan_vjp(activation):
    c = _kernel_case(activation)
    _, vjp = jax.vjp(lambda *a: _lstm_bwd_scan(*a, None, activation),
                     c["xz"], c["rec"], c["hs"], c["cs"], c["dhs"])
    twin = vjp((c["u"], c["v"]))
    _, _, dhT, dcT = _bwd_call(c["xz"], c["rec"], c["hs"], c["cs"], c["dhs"], None,
                               activation, with_carries=True)
    ref = _adj_call(c["xz"], c["rec"], c["hs"], c["cs"], dhT, dcT, c["u"], c["v"],
                    activation)
    got = cuda_lstm.lstm_adj_plain(*(_t(c[k]) for k in ("xz", "rec", "hs", "cs")),
                                   _t(dhT), _t(dcT), _t(c["u"]), _t(c["v"]), activation)
    for name, a, r, t in zip(("uxz", "urec", "uhs", "ucs", "udhs"), got, ref, twin):
        atol = 1e-4 if name == "urec" else 1e-5
        _close(a, r, atol=atol, rtol=1e-4, name=f"{name} vs pallas")
        _close(a, t, atol=atol, rtol=1e-4, name=f"{name} vs scan vjp")


@pytest.mark.parametrize("activation", ACTS)
def test_nested_autograd_matches_torch_double_backward(activation):
    """First order, and the penalty-shaped second order ∂/∂(xz, rec) of
    ‖∂L/∂xz‖², through LSTMFwdRes → LSTMBwdSeq → the adjoint, against
    torch differentiating the plain forward twice by itself."""
    g = np.random.default_rng(11)
    w, b, h = 6, 3, 10
    xz = _t(0.5 * g.normal(size=(w, b, 4 * h))).requires_grad_(True)
    rec = _t(0.4 * g.normal(size=(h, 4 * h))).requires_grad_(True)
    tgt = _t(g.normal(size=(w, b, h)))

    def first(fn):
        return torch.autograd.grad(((fn(xz, rec, activation) - tgt) ** 2).sum(), (xz, rec))

    def second(fn):
        gx, = torch.autograd.grad((fn(xz, rec, activation) * tgt).sum(), xz,
                                  create_graph=True)
        return torch.autograd.grad((gx ** 2).sum(), (xz, rec))

    plain = cuda_lstm.lstm_seq_plain
    for name, fn in (("first", first), ("second", second)):
        for a, r in zip(fn(cuda_lstm.lstm_seq), fn(plain)):
            _close(a.detach(), r.detach(), atol=1e-5, rtol=1e-4, name=name)


def test_cs_cotangent_reaches_the_backward_at_second_order():
    """cs is an output of LSTMFwdRes: the adjoint's ucs flows into it, and
    dropping it (a cs only saved) would change the second order."""
    g = np.random.default_rng(12)
    xz = _t(0.5 * g.normal(size=(4, 2, 24))).requires_grad_(True)
    rec = _t(0.5 * g.normal(size=(6, 24))).requires_grad_(True)
    hs, cs = cuda_lstm.LSTMFwdRes.apply(xz, rec, "tanh")
    assert cs.grad_fn is hs.grad_fn and cs.requires_grad
    gx, = torch.autograd.grad(hs.sum(), xz, create_graph=True)
    got, = torch.autograd.grad((gx ** 2).sum(), rec)
    gx, = torch.autograd.grad(cuda_lstm.lstm_seq_plain(xz, rec, "tanh").sum(), xz,
                              create_graph=True)
    ref, = torch.autograd.grad((gx ** 2).sum(), rec)
    _close(got, ref, atol=1e-5, rtol=1e-4)


def _keras_case(h, f, activation, seed):
    mod = JaxKerasLSTM(h, activation=activation)
    x = jax.random.normal(jax.random.PRNGKey(seed), (4, 6, f))
    params = mod.init(jax.random.PRNGKey(seed), x)["params"]
    port = from_flax(jax.tree_util.tree_map(np.asarray, params),
                     KerasLSTM(f, h, activation=activation, device="cpu"))
    return mod, params, x, port


def _port_grads(port):
    return {n: port.get_parameter(n).grad for n in ("kernel", "recurrent_kernel", "bias")}


@pytest.mark.parametrize("h", [16, 100])
@pytest.mark.parametrize("activation", ["sigmoid", "tanh", None])
def test_keras_first_order_matches_jax(activation, h):
    mod, params, x, port = _keras_case(h, 35, activation, 1)
    wts = jax.random.normal(jax.random.PRNGKey(2), (4, 6, h))
    ref_gp, ref_gx = jax.grad(lambda p, xx: jnp.sum(mod.apply({"params": p}, xx) * wts),
                              argnums=(0, 1))(params, x)
    xt = _t(x).requires_grad_(True)
    (port(xt) * _t(wts)).sum().backward()
    _close(xt.grad, ref_gx, atol=1e-5, rtol=1e-4, name="x")
    for name, gr in _port_grads(port).items():
        _close(gr, ref_gp[name], atol=1e-5, rtol=1e-4, name=name)


def _gp_like_jax(mod):
    def gp_like(p, xx):
        g = jax.grad(lambda xi: jnp.sum(mod.apply({"params": p}, xi, backend="xla")))(xx)
        norms = jnp.sqrt(jnp.sum(g ** 2, axis=(1, 2)) + 1e-12)
        return jnp.mean((1.0 - norms) ** 2)
    return gp_like


def _gp_like_port(port, x):
    xt = x.detach().requires_grad_(True)
    g, = torch.autograd.grad(port(xt).float().sum(), xt, create_graph=True)
    g = g.float()
    norms = torch.sqrt((g ** 2).sum(dim=(1, 2)) + 1e-12)
    return ((1.0 - norms) ** 2).mean()


@pytest.mark.parametrize("activation", ["sigmoid", "tanh", "linear"])
def test_keras_second_order_matches_jax_xla(activation):
    """tests/test_pallas_lstm.py's ``gp_like`` (H=8, F=5): the gradient
    of the input-gradient penalty w.r.t. the params and the input."""
    mod, params, x, port = _keras_case(8, 5, activation, 5)
    gp_like = _gp_like_jax(mod)
    ref_p = jax.grad(gp_like, argnums=0)(params, x)
    ref_x = jax.grad(gp_like, argnums=1)(params, x)
    xt = _t(x).requires_grad_(True)
    _gp_like_port(port, xt).backward()
    for name, gr in _port_grads(port).items():
        _close(gr, ref_p[name], atol=1e-5, rtol=1e-4, name=name)
    # x enters the penalty through its input gradient only; differentiate
    # the penalty as a function of x itself
    xt2 = _t(x).requires_grad_(True)
    gx, = torch.autograd.grad(port(xt2).sum(), xt2, create_graph=True)
    pen = ((1.0 - torch.sqrt((gx ** 2).sum(dim=(1, 2)) + 1e-12)) ** 2).mean()
    got_x, = torch.autograd.grad(pen, xt2)
    _close(got_x, ref_x, atol=1e-5, rtol=1e-4, name="x")


def test_keras_bf16_first_and_second_order_track_f32_jax():
    """bf16 operand streams (f32 state, gate math and cotangents inside,
    cast back at the boundary) against JAX's float32 XLA gradients, at
    the scaled 5e-2 bar of the JAX suite's own bf16 kernel test."""
    mod, params, x, port = _keras_case(8, 5, "sigmoid", 3)
    port.dtype = torch.bfloat16
    wts = jax.random.normal(jax.random.PRNGKey(4), (4, 6, 8))
    ref_gp = jax.grad(lambda p: jnp.sum(mod.apply({"params": p}, x) * wts))(params)
    (port(_t(x)).float() * _t(wts)).sum().backward()
    first = _port_grads(port)
    port.zero_grad()
    ref2 = jax.grad(_gp_like_jax(mod), argnums=0)(params, x)
    _gp_like_port(port, _t(x)).backward()
    for grads, ref in ((first, ref_gp), (_port_grads(port), ref2)):
        for name, gr in grads.items():
            r = np.asarray(ref[name])
            scale = max(float(np.abs(r).max()), 1e-6)
            _close(gr.numpy() / scale, r / scale, atol=5e-2, name=name)
    xz = _t(0.3 * np.ones((3, 2, 32))).to(torch.bfloat16).requires_grad_(True)
    rec = _t(0.1 * np.ones((8, 32))).to(torch.bfloat16).requires_grad_(True)
    dxz, drec = torch.autograd.grad(cuda_lstm.lstm_seq(xz, rec, "sigmoid").sum(), (xz, rec))
    assert dxz.dtype == drec.dtype == torch.bfloat16


def test_wrappers_refuse_what_the_kernels_do_not_take():
    xz, rec = torch.zeros(4, 2, 40), torch.zeros(10, 40)
    seq = torch.zeros(4, 2, 10)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_lstm.lstm_bwd_cuda(xz, rec, seq, seq, seq)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_lstm.lstm_adj_cuda(xz, rec, seq, seq, seq, seq, xz, rec)
    assert cuda_lstm.smem_bytes(100, torch.float32, 2, "lstm_bwd") == 160_400 + 4_000
    assert cuda_lstm.smem_bytes(100, torch.bfloat16, 1, "lstm_adj") == 80_208 + 4_000
    hopper = 232_448
    for kernel in ("lstm_bwd", "lstm_adj"):
        cuda_lstm.check_fits(100, torch.float32, 10, hopper, kernel)
        with pytest.raises(ValueError, match="shared memory"):
            cuda_lstm.check_fits(240, torch.float32, 1, hopper, kernel)
    assert cuda_lstm.reduce_splits(48 * 32, 100, 132) == (10, 160)
    assert cuda_lstm.reduce_splits(5, 100, 132) == (1, 32)
    cuda_lstm.reset_launches()
    assert cuda_lstm.launch_counts() == {"lstm_fwd": 0, "lstm_fwd_cs": 0,
                                         "lstm_bwd": 0, "lstm_adj": 0}
