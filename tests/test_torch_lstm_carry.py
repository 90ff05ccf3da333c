"""The port's LSTM carry modes (``hfrep_tpu_torch.ops.cuda_lstm``) against
the JAX package.

* The plain versions in their carry modes — ``lstm_seq_plain(carry=)``
  (primal and ``with_cs``), ``lstm_bwd_plain(carry=, dc_fin=)`` (with
  ``with_carries`` and with ``dcs``) and ``lstm_adj_plain(carry=, mu0=)``
  — against the Pallas kernels in interpret mode and against the scan
  twins (``_lstm_bwd_scan(carry=, dc_fin=)``, ``jax.vjp`` over it), with
  tests/test_pallas_lstm.py's ``_mk_carry`` set-up: w=5, b=4, hp=128,
  h0 and c0 at scale 0.5.  Bars atol 1e-5 (the adjoint also rtol 1e-4,
  urec atol 1e-4 as the JAX suite allows), scaled by max(1, max|ref|):
  from a nonzero carry the linear activation's state grows to |h| ≈ 26
  in five steps, where float32's spacing is 2e-6 and the two matmuls'
  sum orders differ by 4e-5.
* ``lstm_seq_carry``'s first order against ``jax.grad`` of the JAX
  ``lstm_seq_carry`` (its Pallas kernels in interpret mode), atol 1e-5,
  rtol 1e-4; its ``gp_like`` second order against JAX's double backward
  over an XLA scan twin at w=4, b=2, atol 2e-4, rtol 1e-4.
* A zero carry reproduces ``lstm_seq``; chunks chained through the carry
  reproduce the whole window, at first and second order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfrep_tpu.ops.pallas_lstm import (_ACT, _adj_call, _bwd_call, _lstm_bwd_scan,
                                       _lstm_seq_fwd_impl)
from hfrep_tpu.ops.pallas_lstm import lstm_seq_carry as jax_lstm_seq_carry
from hfrep_tpu_torch.ops import cuda_lstm

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


def _close_scaled(got, ref, atol=1e-5, rtol=0.0, name=""):
    """``_close`` with atol scaled by max(1, max|ref|)."""
    scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
    _close(got, ref, atol=atol * scale, rtol=rtol, name=name)


def _mk_carry(key, w=W, b=B, hp=HP):
    """tests/test_pallas_lstm.py's ``_mk_carry``."""
    ks = jax.random.split(key, 4)
    xz = 0.3 * jax.random.normal(ks[0], (w, b, 4 * hp))
    rec = 0.3 * jax.random.normal(ks[1], (hp, 4 * hp))
    h0 = 0.5 * jax.random.normal(ks[2], (b, hp))
    c0 = 0.5 * jax.random.normal(ks[3], (b, hp))
    return xz, rec, h0, c0


def _fwd_scan_carry(xz, rec, h0, c0, activation):
    """The XLA scan twin of the carry forward (tests/test_pallas_lstm.py)."""
    act = _ACT[activation]

    def step(carry, xz_t):
        h, c = carry
        z = xz_t + h @ rec
        zi, zf, zc, zo = jnp.split(z, 4, axis=-1)
        c2 = jax.nn.sigmoid(zf) * c + jax.nn.sigmoid(zi) * act(zc)
        h2 = jax.nn.sigmoid(zo) * act(c2)
        return (h2, c2), h2

    (_, c_f), hs = jax.lax.scan(step, (h0, c0), xz)
    return hs, c_f


def _bwd_case(activation):
    """tests/test_pallas_lstm.py's carry-adjoint set-up (key 16)."""
    key = jax.random.PRNGKey(16)
    xz, rec, h0, c0 = _mk_carry(key)
    ks = jax.random.split(jax.random.fold_in(key, 1), 5)
    hs, cs = _lstm_seq_fwd_impl(xz, rec, activation, with_cs=True, carry=(h0, c0))
    return dict(xz=xz, rec=rec, h0=h0, c0=c0, hs=hs, cs=cs,
                dhs=0.3 * jax.random.normal(ks[0], (W, B, HP)),
                dc_fin=0.3 * jax.random.normal(ks[1], (B, HP)),
                u=0.3 * jax.random.normal(ks[2], (W, B, 4 * HP)),
                v=0.3 * jax.random.normal(ks[3], (HP, 4 * HP)),
                muh0=0.3 * jax.random.normal(ks[4], (B, HP)),
                muc0=0.3 * jax.random.normal(jax.random.fold_in(ks[4], 1), (B, HP)),
                dcs=0.3 * jax.random.normal(jax.random.fold_in(ks[0], 1), (W, B, HP)))


@pytest.mark.parametrize("activation", ACTS)
def test_carry_forward_matches_pallas(activation):
    xz, rec, h0, c0 = _mk_carry(jax.random.PRNGKey(11))
    carry_t = (_t(h0), _t(c0))
    hs, c_fin = cuda_lstm.lstm_seq_plain(_t(xz), _t(rec), activation, carry=carry_t)
    ref_hs, ref_cf = _lstm_seq_fwd_impl(xz, rec, activation, with_cs=False, carry=(h0, c0))
    _close_scaled(hs, ref_hs, name="hs")
    _close_scaled(c_fin, ref_cf, name="c_fin")
    hs2, cs = cuda_lstm.lstm_seq_plain(_t(xz), _t(rec), activation, with_cs=True,
                                       carry=carry_t)
    ref_hs2, ref_cs = _lstm_seq_fwd_impl(xz, rec, activation, with_cs=True, carry=(h0, c0))
    _close_scaled(hs2, ref_hs2, name="hs (with_cs)")
    _close_scaled(cs, ref_cs, name="cs")
    twin_hs, twin_cf = _fwd_scan_carry(xz, rec, h0, c0, activation)
    _close_scaled(hs, twin_hs, name="hs vs scan twin")
    _close_scaled(c_fin, twin_cf, name="c_fin vs scan twin")


@pytest.mark.parametrize("mode", ["with_carries", "dcs"])
@pytest.mark.parametrize("activation", ACTS)
def test_carry_bwd_plain_matches_pallas_and_scan(activation, mode):
    c = _bwd_case(activation)
    carry, carry_t = (c["h0"], c["c0"]), (_t(c["h0"]), _t(c["c0"]))
    dcs = c["dcs"] if mode == "dcs" else None
    carries = mode == "with_carries"
    ref = _bwd_call(c["xz"], c["rec"], c["hs"], c["cs"], c["dhs"], dcs, activation,
                    with_carries=carries, carry=carry, dc_fin=c["dc_fin"])
    twin = _lstm_bwd_scan(c["xz"], c["rec"], c["hs"], c["cs"], c["dhs"], dcs, activation,
                          carry=carry, dc_fin=c["dc_fin"])
    got = cuda_lstm.lstm_bwd_plain(*(_t(c[k]) for k in ("xz", "rec", "hs", "cs", "dhs")),
                                   None if dcs is None else _t(dcs), activation,
                                   with_carries=carries, carry=carry_t,
                                   dc_fin=_t(c["dc_fin"]))
    names = ("dxz", "drec") + (("dhT", "dcT") if carries else ()) + ("dh0", "dc0")
    assert len(got) == len(ref) == len(names)
    for name, a, r in zip(names, got, ref):
        _close_scaled(a, r, name=f"{name} vs pallas")
    got_twin = got[:2] + got[-2:]
    for name, a, r in zip(("dxz", "drec", "dh0", "dc0"), got_twin, twin):
        _close_scaled(a, r, name=f"{name} vs scan twin")


@pytest.mark.parametrize("activation", ACTS)
def test_carry_adj_plain_matches_pallas_and_scan_vjp(activation):
    c = _bwd_case(activation)
    carry = (c["h0"], c["c0"])
    _, vjp = jax.vjp(
        lambda xz, rec, hs, cs, dhs, dcf, h0, c0: _lstm_bwd_scan(
            xz, rec, hs, cs, dhs, None, activation, carry=(h0, c0), dc_fin=dcf),
        c["xz"], c["rec"], c["hs"], c["cs"], c["dhs"], c["dc_fin"], c["h0"], c["c0"])
    twin = vjp((c["u"], c["v"], c["muh0"], c["muc0"]))
    _, _, dhT, dcT, _, _ = _bwd_call(c["xz"], c["rec"], c["hs"], c["cs"], c["dhs"], None,
                                     activation, with_carries=True, carry=carry,
                                     dc_fin=c["dc_fin"])
    ref = _adj_call(c["xz"], c["rec"], c["hs"], c["cs"], dhT, dcT, c["u"], c["v"],
                    activation, carry=carry, mu0=(c["muh0"], c["muc0"]))
    got = cuda_lstm.lstm_adj_plain(
        *(_t(c[k]) for k in ("xz", "rec", "hs", "cs")), _t(dhT), _t(dcT), _t(c["u"]),
        _t(c["v"]), activation, carry=(_t(c["h0"]), _t(c["c0"])),
        mu0=(_t(c["muh0"]), _t(c["muc0"])))
    names = ("uxz", "urec", "uhs", "ucs", "udhs", "u_dcfin", "uh0", "uc0")
    assert len(got) == len(ref) == len(twin) == 8
    for name, a, r, t in zip(names, got, ref, twin):
        atol = 1e-4 if name == "urec" else 1e-5
        _close_scaled(a, r, atol=atol, rtol=1e-4, name=f"{name} vs pallas")
        _close_scaled(a, t, atol=atol, rtol=1e-4, name=f"{name} vs scan vjp")


@pytest.mark.parametrize("activation", ["sigmoid", "tanh"])
def test_lstm_seq_carry_first_order_matches_jax(activation):
    """Cotangents on both outputs (hs and c_fin), as the JAX suite's
    ``test_carry_gradients_match_scan_twin``."""
    xz, rec, h0, c0 = _mk_carry(jax.random.PRNGKey(12))
    wts = jax.random.normal(jax.random.PRNGKey(13), (W, B, HP))
    u = jax.random.normal(jax.random.PRNGKey(14), (B, HP))

    def loss(xz, rec, h0, c0):
        hs, c_fin = jax_lstm_seq_carry(xz, rec, h0, c0, activation)
        return jnp.sum(hs * wts) + jnp.sum(c_fin * u)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(xz, rec, h0, c0)
    args = [_t(a).requires_grad_(True) for a in (xz, rec, h0, c0)]
    hs, c_fin = cuda_lstm.lstm_seq_carry(*args, activation)
    got = torch.autograd.grad((hs * _t(wts)).sum() + (c_fin * _t(u)).sum(), args)
    for name, a, r in zip(("dxz", "drec", "dh0", "dc0"), got, ref):
        _close(a, r, atol=1e-5, rtol=1e-4, name=name)


def _gp_like_torch(fn, args, activation):
    xz, rec, h0, c0 = args
    hs, c_fin = fn(xz, rec, h0, c0, activation)
    g = torch.autograd.grad(hs.sum() + c_fin.sum(), (xz, h0, c0), create_graph=True)
    norms = torch.sqrt(sum((t ** 2).sum() for t in g) + 1e-12)
    return (1.0 - norms) ** 2


@pytest.mark.parametrize("activation", ["sigmoid", "tanh"])
def test_lstm_seq_carry_second_order_matches_jax_scan_twin(activation):
    """tests/test_pallas_lstm.py's ``gp_like`` (w=4, b=2) for each
    argument, against JAX's double backward over the XLA scan twin."""
    xz, rec, h0, c0 = _mk_carry(jax.random.PRNGKey(15), w=4, b=2)

    def gp_like(xz, rec, h0, c0):
        def scalar(xzi, h0i, c0i):
            hs, c_fin = _fwd_scan_carry(xzi, rec, h0i, c0i, activation)
            return jnp.sum(hs) + jnp.sum(c_fin)
        g = jax.grad(scalar, argnums=(0, 1, 2))(xz, h0, c0)
        norms = jnp.sqrt(sum(jnp.sum(t ** 2) for t in g) + 1e-12)
        return (1.0 - norms) ** 2

    ref = jax.grad(gp_like, argnums=(0, 1, 2, 3))(xz, rec, h0, c0)
    args = [_t(a).requires_grad_(True) for a in (xz, rec, h0, c0)]
    got = torch.autograd.grad(_gp_like_torch(cuda_lstm.lstm_seq_carry, args, activation),
                              args)
    for wrt, (a, r) in enumerate(zip(got, ref)):
        _close(a, r, atol=2e-4, rtol=1e-4, name=f"wrt={wrt}")


def _small_case(seed, w=9, b=3, h=6):
    g = np.random.default_rng(seed)
    return [_t(s * g.normal(size=shape)).requires_grad_(True)
            for s, shape in ((0.5, (w, b, 4 * h)), (0.4, (h, 4 * h)), (0.5, (b, h)),
                             (0.5, (b, h)))]


@pytest.mark.parametrize("activation", ACTS)
def test_zero_carry_reproduces_lstm_seq(activation):
    """(h0, c0) = 0: the same hs as ``lstm_seq``, c_fin its last cell
    state, and the same first and penalty-shaped second order in xz and
    rec."""
    xz, rec, _, _ = _small_case(21)
    z = torch.zeros(xz.shape[1], rec.shape[0])
    hs, c_fin = cuda_lstm.lstm_seq_carry(xz, rec, z, z, activation)
    ref_hs, ref_cs = cuda_lstm.LSTMFwdRes.apply(xz, rec, activation)
    _close(hs.detach(), ref_hs.detach(), atol=0.0, name="hs")
    _close(c_fin.detach(), ref_cs[-1].detach(), atol=0.0, name="c_fin")
    tgt = _t(np.random.default_rng(22).normal(size=hs.shape))

    def orders(fn):
        gx, = torch.autograd.grad((fn(xz, rec) * tgt).sum(), xz, create_graph=True)
        return (gx,) + torch.autograd.grad((gx ** 2).sum(), (xz, rec))

    got = orders(lambda x, r: cuda_lstm.lstm_seq_carry(x, r, z, z, activation)[0])
    ref = orders(lambda x, r: cuda_lstm.lstm_seq(x, r, activation))
    for name, a, r in zip(("gx", "second xz", "second rec"), got, ref):
        _close(a.detach(), r.detach(), atol=0.0, name=name)


@pytest.mark.parametrize("activation", ACTS)
def test_carry_autograd_matches_torch_double_backward(activation):
    """LSTMFwdResCarry → LSTMBwdSeqCarry → the carry adjoint, first order
    and ``gp_like``, against torch differentiating the plain carry forward
    twice by itself."""
    args = _small_case(23)
    wts = _t(np.random.default_rng(24).normal(size=(9, 3, 6)))
    u = _t(np.random.default_rng(25).normal(size=(3, 6)))

    def plain(xz, rec, h0, c0, act):
        return cuda_lstm.lstm_seq_plain(xz, rec, act, carry=(h0, c0))

    def first(fn):
        hs, c_fin = fn(*args, activation)
        return torch.autograd.grad((hs * wts).sum() + (c_fin * u).sum(), args)

    for name, got, ref in (
            ("first", first(cuda_lstm.lstm_seq_carry), first(plain)),
            ("second", torch.autograd.grad(
                _gp_like_torch(cuda_lstm.lstm_seq_carry, args, activation), args),
             torch.autograd.grad(_gp_like_torch(plain, args, activation), args))):
        for wrt, (a, r) in enumerate(zip(got, ref)):
            _close(a, r, atol=1e-5, rtol=1e-4, name=f"{name} wrt={wrt}")


def _chunked(xz, rec, h0, c0, activation, cut):
    hs, h, c = [], h0, c0
    for k in range(0, xz.shape[0], cut):
        hs_k, c = cuda_lstm.lstm_seq_carry(xz[k:k + cut], rec, h, c, activation)
        hs.append(hs_k)
        h = hs_k[-1]
    return torch.cat(hs), c


@pytest.mark.parametrize("activation", ["sigmoid", "tanh"])
def test_chained_chunks_reproduce_the_whole_window(activation):
    """Three chunks of 3 that pass (h, c) on against one window of 9: the
    forward exactly, the loss's gradients and ``gp_like`` for each
    argument within the JAX suite's bars."""
    args = _small_case(26)
    wts = _t(np.random.default_rng(27).normal(size=(9, 3, 6)))
    whole = cuda_lstm.lstm_seq_carry
    chunks = functools.partial(_chunked, cut=3)
    hs, c_fin = chunks(*args, activation)
    ref_hs, ref_cf = whole(*args, activation)
    _close(hs.detach(), ref_hs.detach(), atol=0.0, name="hs")
    _close(c_fin.detach(), ref_cf.detach(), atol=0.0, name="c_fin")

    def first(fn):
        hs, c_fin = fn(*args, activation)
        return torch.autograd.grad((hs * wts).sum() + c_fin.sum(), args)

    for wrt, (a, r) in enumerate(zip(first(chunks), first(whole))):
        _close(a, r, atol=1e-5, rtol=1e-4, name=f"first wrt={wrt}")
    got = torch.autograd.grad(_gp_like_torch(chunks, args, activation), args)
    ref = torch.autograd.grad(_gp_like_torch(whole, args, activation), args)
    for wrt, (a, r) in enumerate(zip(got, ref)):
        _close(a, r, atol=2e-4, rtol=1e-4, name=f"second wrt={wrt}")


def test_carry_arguments_are_checked():
    xz, rec = torch.zeros(4, 2, 40), torch.zeros(10, 40)
    seq, st = torch.zeros(4, 2, 10), torch.zeros(2, 10)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_lstm.lstm_fwd_cuda(xz, rec, "tanh", carry=(st, st))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_lstm.lstm_bwd_cuda(xz, rec, seq, seq, seq, carry=(st, st), dc_fin=st)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_lstm.lstm_adj_cuda(xz, rec, seq, seq, seq, seq, xz, rec, carry=(st, st),
                                mu0=(st, st))
    with pytest.raises(ValueError, match="carry mode"):
        cuda_lstm.lstm_bwd(xz, rec, seq, seq, seq, dc_fin=st)
    with pytest.raises(ValueError, match="carry mode"):
        cuda_lstm.lstm_adj(xz, rec, seq, seq, seq, seq, xz, rec, mu0=(st, st))
    hs, c_fin = cuda_lstm.lstm_fwd(xz, rec, "tanh", carry=(st, st))
    assert hs.shape == (4, 2, 10) and c_fin.shape == (2, 10)
    out = cuda_lstm.lstm_bwd(xz, rec, seq, seq, seq, carry=(st, st))
    assert [tuple(t.shape) for t in out] == [(4, 2, 40), (10, 40), (2, 10), (2, 10)]
    out = cuda_lstm.lstm_adj(xz, rec, seq, seq, seq, seq, xz, rec, carry=(st, st))
    assert len(out) == 8 and all(tuple(t.shape) == (2, 10) for t in out[5:])
