"""The port's fused two-layer LSTM stack (``hfrep_tpu_torch.ops.cuda_lstm_stack``)
against the JAX package.

* The plain versions of kernels 4–6 — ``stack_seq_plain`` (primal and
  ``with_res``), ``stack_bwd_plain`` (plain, direct-cotangent and
  ``with_carries`` modes) and ``stack_adj_plain`` — against the Pallas
  kernels in interpret mode (``_stack_fwd_impl``, ``_stack_bwd_call``,
  ``_stack_adj_call`` fed with the backward's carries), at hp = 128 so
  the padded JAX layout and the port's unpadded one coincide; W=5, B=4,
  every activation.  Bars atol 1e-5, with rtol 1e-4 on the adjoint; the
  W·B-row sums (drec1, dk2, db2, drec2, ur1, uk2, ub2, ur2) atol 1e-4.
  The adjoint's output shift is also held at W=1.
* The adjoint as ``csrc/lstm_stack_adj.cu``'s cluster layout groups it
  (a pre-pass of what reads only saved states, a chain of
  ``round(mu_h) . rec`` and ``round(dhTbar1) . k2`` alone, a post-pass of
  the transposed products with the h-shift in its row reads, the sums)
  against ``stack_adj_plain`` (f32 atol 1e-5; bf16 scaled 1e-2, the
  card's bar) and against ``_stack_adj_call`` in interpret mode at the
  JAX bars (second order atol 2e-4, rtol 1e-4; bf16 scaled 3e-2), W in
  {1, 2, 7}, every activation.
* The nested autograd (``StackFwdRes`` → ``StackBwdSeq`` → the adjoint)
  at first and the penalty-shaped second order against torch's own
  double backward over the plain forward: atol 1e-5, rtol 1e-4.
* ``keras_lstm_stack`` against ``jax.grad`` through two chained JAX
  ``KerasLSTM``s on the scan (``backend="xla"``), H in {8, 100}, first
  order and the penalty-shaped second order, atol 1e-5, rtol 1e-4; bf16
  operand streams against the float32 JAX gradients at the scaled 5e-2
  bar of tests/test_pallas_stack.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfrep_tpu.ops.lstm import KerasLSTM as JaxKerasLSTM
from hfrep_tpu.ops.pallas_lstm_stack import (_stack_adj_call, _stack_bwd_call,
                                             _stack_fwd_impl)
from hfrep_tpu_torch.ops import cuda_lstm, cuda_lstm_stack as cls

ACTS = ["sigmoid", "tanh", "linear"]
W, B, HP = 5, 4, 128
SUMS = {"drec1", "dk2", "db2", "drec2", "ur1", "uk2", "ub2", "ur2"}
BWD_NAMES = ("dxz1", "drec1", "dk2", "db2", "drec2", "dhT1", "dcT1", "dhT2", "dcT2")
ADJ_NAMES = ("uxz1", "ur1", "uk2", "ub2", "ur2", "uhs1", "ucs1", "uhs2", "ucs2", "udhs2")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, ref, atol=1e-5, rtol=0.0, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol,
                               rtol=rtol, err_msg=name)


def _case(activation, w=W):
    """Seeded operands at hp = 128 and the Pallas forward's residuals."""
    g = np.random.default_rng(17)
    n = lambda s, *shape: (s * g.normal(size=shape)).astype(np.float32)  # noqa: E731
    gw = 4 * HP
    c = dict(xz1=n(0.5, w, B, gw), rec1=n(0.1, HP, gw), k2=n(0.1, HP, gw),
             b2=n(0.3, gw), rec2=n(0.1, HP, gw), dhs2=n(0.3, w, B, HP),
             dhs1=n(0.3, w, B, HP), dcs1=n(0.3, w, B, HP), dcs2=n(0.3, w, B, HP),
             u1=n(0.3, w, B, gw), vr1=n(0.3, HP, gw), vk2=n(0.3, HP, gw),
             vb2=n(0.3, gw), vr2=n(0.3, HP, gw))
    c = {k: jnp.asarray(v) for k, v in c.items()}
    c["hs1"], c["cs1"], c["hs2"], c["cs2"] = _stack_fwd_impl(
        c["xz1"], c["rec1"], c["k2"], c["b2"], c["rec2"], activation, with_res=True)
    return c


def _args(c, *names):
    return [_t(c[k]) for k in names]


WEIGHTS = ("xz1", "rec1", "k2", "b2", "rec2")
RESID = ("hs1", "cs1", "hs2", "cs2")


@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("activation", ACTS)
def test_stack_forward_matches_pallas(activation, with_res):
    c = _case(activation)
    got = cls.stack_seq_plain(*_args(c, *WEIGHTS), activation, with_res=with_res)
    if with_res:
        for name, a in zip(RESID, got):
            _close(a, c[name], name=name)
    else:
        ref = _stack_fwd_impl(*(c[k] for k in WEIGHTS), activation, with_res=False)
        _close(got, ref, name="hs2")
        _close(got, c["hs2"], name="hs2 vs with_res")


@pytest.mark.parametrize("mode", ["plain", "directs", "with_carries"])
@pytest.mark.parametrize("activation", ACTS)
def test_stack_bwd_plain_matches_pallas(activation, mode):
    c = _case(activation)
    directs = ("dhs1", "dcs1", "dcs2") if mode == "directs" else None
    carries = mode == "with_carries"
    ref = _stack_bwd_call(*(c[k] for k in WEIGHTS + RESID), c["dhs2"],
                          None if directs is None else tuple(c[k] for k in directs),
                          activation, with_carries=carries)
    got = cls.stack_bwd_plain(*_args(c, *WEIGHTS + RESID + ("dhs2",)),
                              None if directs is None else tuple(_args(c, *directs)),
                              activation, with_carries=carries)
    assert len(got) == len(ref) == (9 if carries else 5)
    for name, a, r in zip(BWD_NAMES, got, ref):
        _close(a, r, atol=1e-4 if name in SUMS else 1e-5, name=name)


def _adj_pair(activation, w=W):
    c = _case(activation, w)
    carries = _stack_bwd_call(*(c[k] for k in WEIGHTS + RESID), c["dhs2"], None,
                              activation, with_carries=True)[5:]
    v = ("u1", "vr1", "vk2", "vb2", "vr2")
    ref = _stack_adj_call(*(c[k] for k in WEIGHTS + RESID), *carries,
                          *(c[k] for k in v), activation)
    got = cls.stack_adj_plain(*_args(c, *WEIGHTS + RESID), *(_t(x) for x in carries),
                              *_args(c, *v), activation)
    return got, ref


@pytest.mark.parametrize("activation", ACTS)
def test_stack_adj_plain_matches_pallas(activation):
    got, ref = _adj_pair(activation)
    assert len(got) == len(ref) == 10
    for name, a, r in zip(ADJ_NAMES, got, ref):
        _close(a, r, atol=1e-4 if name in SUMS else 1e-5, rtol=1e-4, name=name)


@functools.lru_cache(maxsize=None)
def _adj_case(activation, w):
    """_case's operands and residuals, the Pallas backward's carries."""
    c = _case(activation, w)
    carries = _stack_bwd_call(*(c[k] for k in WEIGHTS + RESID), c["dhs2"], None,
                              activation, with_carries=True)[5:]
    return c, carries


def _adj_regrouped(xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2, dhT1, dcT1, dhT2, dcT2,
                   u1, vr1, vk2, vb2, vr2, activation):
    """The adjoint as the kernel's cluster layout groups it: what reads only
    saved states over all W*B rows first (both layers' gates; base1 = u1 +
    h1_{t-1} . vr1 and base2 = vb2 + h1_t . vk2 + h2_{t-1} . vr2 from
    unrounded states), then a chain that carries only round(mu_h1) . rec1,
    round(dhTbar1) . k2 and round(mu_h2) . rec2, then the transposed
    products over all rows with the h-shift in the row reads (each output
    one product over its terms end to end), then the four sums."""
    code = cuda_lstm.act_code(activation)
    w, b, g = xz1.shape
    h = g // 4
    r1, kk, r2, bb = rec1.float(), k2.float(), rec2.float(), b2.float()
    rnd = cuda_lstm._rounder(rec1)
    rows = lambda s: s.reshape(w * b, -1)                                  # noqa: E731
    nxt = lambda s: torch.cat([s[1:], torch.zeros_like(s[:1])])           # noqa: E731
    prev = cuda_lstm._shifted
    h1p, c1p, h2p, c2p = (prev(s) for s in (hs1, cs1, hs2, cs2))
    z1 = (rows(xz1.float()) + rows(rnd(h1p)) @ r1).reshape(w, b, g)
    z2 = (bb + rows(rnd(torch.cat([hs1, h2p], -1))) @ torch.cat([kk, r2])).reshape(w, b, g)
    base1 = (rows(u1) + rows(h1p) @ vr1).reshape(w, b, g)
    base2 = (vb2 + rows(torch.cat([hs1, h2p], -1)) @ torch.cat([vk2, vr2])).reshape(w, b, g)
    dz1, zb1, dz2, zb2 = (torch.empty((w, b, g)) for _ in range(4))
    dhtb1, udhs2, uc1, uc1p, uc2, uc2p = (torch.empty((w, b, h)) for _ in range(6))
    muh1, muc1, muh2, muc2 = (torch.zeros((b, h)) for _ in range(4))
    for t in range(w):
        dz1[t], zb1[t], dhtb1[t], muc1, uc1p[t], uc1[t] = cuda_lstm._adj_step(
            code, z1[t], cs1[t], c1p[t], dhT1[t], dcT1[t], muc1, base1[t] + rnd(muh1) @ r1)
        dzbar2 = base2[t] + (rnd(dhtb1[t]) @ kk + rnd(muh2) @ r2)
        dz2[t], zb2[t], udhs2[t], muc2, uc2p[t], uc2[t] = cuda_lstm._adj_step(
            code, z2[t], cs2[t], c2p[t], dhT2[t], dcT2[t], muc2, dzbar2)
        muh1, muh2 = dhtb1[t], udhs2[t]
    uhs1 = rows(torch.cat([rnd(zb2), dz2, nxt(dz1), nxt(rnd(zb1))], -1)) @ torch.cat(
        [kk, vk2, vr1, r1], -1).T
    uhs2 = rows(torch.cat([nxt(dz2), nxt(rnd(zb2))], -1)) @ torch.cat([vr2, r2], -1).T
    ur1 = rows(prev(dhtb1)).T @ rows(dz1) + rows(h1p).T @ rows(zb1)
    uk2 = rows(hs1).T @ rows(zb2) + rows(dhtb1).T @ rows(dz2)
    ur2 = rows(prev(udhs2)).T @ rows(dz2) + rows(h2p).T @ rows(zb2)
    return (zb1, ur1, uk2, rows(zb2).sum(0), ur2, uhs1.reshape(w, b, h), uc1 + nxt(uc1p),
            uhs2.reshape(w, b, h), uc2 + nxt(uc2p), udhs2)


def _scaled(got, ref):
    got, ref = np.asarray(got, dtype=np.float32), np.asarray(ref, dtype=np.float32)
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("w", [1, 2, 7])
def test_stack_adj_regrouped_matches_plain_and_pallas(w, activation, bf16):
    """The cluster layout's grouping of the adjoint computes the same
    function: against the plain step loop and the Pallas kernel, xz1 and
    the four weights in float32 or rounded to bf16 alike in both
    frameworks."""
    c, carries = _adj_case(activation, w)
    v = ("u1", "vr1", "vk2", "vb2", "vr2")
    rest = [c[k] for k in RESID] + list(carries) + [c[k] for k in v]
    jw = [c[k].astype(jnp.bfloat16) if bf16 else c[k] for k in WEIGHTS]
    tw = [_t(c[k]).to(torch.bfloat16) if bf16 else _t(c[k]) for k in WEIGHTS]
    targs = tw + [_t(x) for x in rest]
    pallas = _stack_adj_call(*jw, *rest, activation)
    plain = cls.stack_adj_plain(*targs, activation)
    got = _adj_regrouped(*targs, activation)
    assert len(got) == len(plain) == len(pallas) == 10
    for name, a, p, r in zip(ADJ_NAMES, got, plain, pallas):
        assert a.shape == p.shape == r.shape, name
        if bf16:
            assert _scaled(a, p) <= 1e-2, (name, _scaled(a, p))
            assert _scaled(a, r) <= 3e-2, (name, _scaled(a, r))
        else:
            _close(a, p, atol=1e-5, name=name)
            _close(a, r, atol=2e-4, rtol=1e-4, name=name)


def test_stack_adj_output_shift_at_one_step():
    """At W=1 every shifted term is the zero past the end: uhs2 is zero,
    uhs1/ucs1/ucs2 are the direct terms alone."""
    got, ref = _adj_pair("tanh", w=1)
    assert float(got[ADJ_NAMES.index("uhs2")].abs().max()) == 0.0
    for name, a, r in zip(ADJ_NAMES, got, ref):
        _close(a, r, atol=1e-4 if name in SUMS else 1e-5, rtol=1e-4, name=name)


def _small_weights(g, h):
    """(xz1, rec1, k2, b2, rec2) leaves that need a gradient."""
    mk = lambda s, *shape: _t(s * g.normal(size=shape)).requires_grad_(True)  # noqa: E731
    return (mk(0.5, 6, 3, 4 * h), mk(0.4, h, 4 * h), mk(0.4, h, 4 * h),
            mk(0.3, 4 * h), mk(0.4, h, 4 * h))


@pytest.mark.parametrize("activation", ACTS)
def test_stack_nested_autograd_matches_torch_double_backward(activation):
    """First order, and the penalty-shaped second order ∂/∂(every operand)
    of ‖∂L/∂xz1‖², through StackFwdRes → StackBwdSeq → the adjoint,
    against torch differentiating the plain forward twice by itself."""
    g = np.random.default_rng(21)
    ops = _small_weights(g, 10)
    tgt = _t(g.normal(size=(6, 3, 10)))

    def first(fn):
        return torch.autograd.grad(((fn(*ops, activation) - tgt) ** 2).sum(), ops)

    def second(fn):
        gx, = torch.autograd.grad((fn(*ops, activation) * tgt).sum(), ops[0],
                                  create_graph=True)
        return torch.autograd.grad((gx ** 2).sum(), ops)

    for name, fn in (("first", first), ("second", second)):
        for k, (a, r) in enumerate(zip(fn(cls.stack_seq), fn(cls.stack_seq_plain))):
            _close(a.detach(), r.detach(), atol=1e-5, rtol=1e-4, name=f"{name} {k}")


def _keras_problem(h, seed=0):
    """tests/test_pallas_stack.py's problem: x (3, 6, 5), two KerasLSTM(h)."""
    key = jax.random.PRNGKey(seed)
    x = jax.random.normal(key, (3, 6, 5))
    l1, l2 = JaxKerasLSTM(h, activation="tanh"), JaxKerasLSTM(h, activation="tanh")
    p1 = l1.init(key, x)["params"]
    p2 = l2.init(jax.random.PRNGKey(seed + 1), l1.apply({"params": p1}, x))["params"]

    def chained(a, b, xx):
        return l2.apply({"params": b}, l1.apply({"params": a}, xx, backend="xla"),
                        backend="xla")

    return p1, p2, x, chained


def _port_params(p):
    return {k: _t(v).requires_grad_(True) for k, v in p.items()}


def _gp_jax(chained):
    def gp(a, b, xx):
        g = jax.grad(lambda xi: jnp.sum(chained(a, b, xi)))(xx)
        return jnp.mean((1.0 - jnp.sqrt(jnp.sum(g ** 2, axis=(1, 2)) + 1e-12)) ** 2)
    return gp


def _gp_port(q1, q2, xt, dtype=None):
    gx, = torch.autograd.grad(
        cls.keras_lstm_stack(q1, q2, xt, "tanh", dtype=dtype).float().sum(), xt,
        create_graph=True)
    gx = gx.float()
    return ((1.0 - torch.sqrt((gx ** 2).sum(dim=(1, 2)) + 1e-12)) ** 2).mean()


def _check_grads(got, ref, name, scaled=False):
    """``got`` (p1 dict, p2 dict, x grad) against ``ref`` (JAX's)."""
    for part, g, r in zip(("p1", "p2"), got[:2], ref[:2]):
        for k in r:
            _check_one(g[k], r[k], f"{name} {part}.{k}", scaled)
    _check_one(got[2], ref[2], f"{name} x", scaled)


def _check_one(g, r, name, scaled):
    g, r = g.detach().float().numpy(), np.asarray(r)
    if scaled:
        s = max(float(np.abs(r).max()), 1e-6)
        _close(g / s, r / s, atol=5e-2, name=name)
    else:
        _close(g, r, atol=1e-5, rtol=1e-4, name=name)


@pytest.mark.parametrize("h", [8, 100])
def test_keras_lstm_stack_first_order_matches_jax_chained(h):
    p1, p2, x, chained = _keras_problem(h)
    wts = jax.random.normal(jax.random.PRNGKey(2), (3, 6, h))
    ref_out = chained(p1, p2, x)
    ref = jax.grad(lambda a, b, xx: jnp.sum(chained(a, b, xx) * wts),
                   argnums=(0, 1, 2))(p1, p2, x)
    q1, q2, xt = _port_params(p1), _port_params(p2), _t(x).requires_grad_(True)
    out = cls.keras_lstm_stack(q1, q2, xt, "tanh")
    _close(out.detach(), ref_out, atol=1e-6, name="forward")
    (out * _t(wts)).sum().backward()
    _check_grads(({k: v.grad for k, v in q1.items()}, {k: v.grad for k, v in q2.items()},
                  xt.grad), ref, f"H={h}")


def test_keras_lstm_stack_second_order_matches_jax_chained():
    """The penalty's shape: ∂/∂(p1, p2, x) of mean((1 − ‖∇ₓ f‖)²)."""
    p1, p2, x, chained = _keras_problem(8)
    ref = jax.grad(_gp_jax(chained), argnums=(0, 1, 2))(p1, p2, x)
    q1, q2, xt = _port_params(p1), _port_params(p2), _t(x).requires_grad_(True)
    got = torch.autograd.grad(_gp_port(q1, q2, xt),
                              list(q1.values()) + list(q2.values()) + [xt])
    n1 = len(q1)
    _check_grads((dict(zip(q1, got[:n1])), dict(zip(q2, got[n1:-1])), got[-1]),
                 ref, "gp")


def test_keras_lstm_stack_bf16_tracks_f32_jax():
    """bf16 operand streams (float32 state, gate math and cotangents
    inside, cast back at the boundary) against JAX's float32 chained
    gradients, first and second order, at the scaled 5e-2 bar."""
    p1, p2, x, chained = _keras_problem(8)
    wts = jax.random.normal(jax.random.PRNGKey(4), (3, 6, 8))
    ref1 = jax.grad(lambda a, b, xx: jnp.sum(chained(a, b, xx) * wts),
                    argnums=(0, 1, 2))(p1, p2, x)
    ref2 = jax.grad(_gp_jax(chained), argnums=(0, 1, 2))(p1, p2, x)
    q1, q2 = _port_params(p1), _port_params(p2)
    leaves = list(q1.values()) + list(q2.values())
    n1 = len(q1)
    xt = _t(x).requires_grad_(True)
    out = cls.keras_lstm_stack(q1, q2, xt, "tanh", dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    got1 = torch.autograd.grad((out.float() * _t(wts)).sum(), leaves + [xt])
    got2 = torch.autograd.grad(_gp_port(q1, q2, xt, torch.bfloat16), leaves + [xt])
    for name, got, ref in (("bf16 first", got1, ref1), ("bf16 gp", got2, ref2)):
        _check_grads((dict(zip(q1, got[:n1])), dict(zip(q2, got[n1:-1])), got[-1]),
                     ref, name, scaled=True)


@pytest.mark.parametrize("batch", [1, 64, 133])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [8, 100, 101, 117, 164])
def test_stack_fwd_layout_rule(hidden, dtype, batch):
    """The forward's launch rule on a 132-SM card: the cluster layout (two
    blocks of 416 threads a batch row, ceil(B / 66) rows a cluster) up to
    H=100, the wide layout (``stack_rows`` rows a block, a thread per row
    and unit) above it within ``stack_fits``; a width the fused stack
    refuses raises, and nothing ``stack_fits`` admits does."""
    sms, limit = 132, cls.HOPPER_SMEM_BYTES
    if not cls.stack_fits(hidden, dtype):
        with pytest.raises(ValueError, match="chained route"):
            cls.stack_fwd_layout(hidden, dtype, batch, sms, limit)
        return
    layout, threads, rows = cls.stack_fwd_layout(hidden, dtype, batch, sms, limit)
    clusters = -(-batch // rows)
    if hidden <= 100:
        assert (layout, threads) == ("cluster", 416)
        assert rows == -(-batch // 66) and (clusters - 1) * rows < batch
        assert 2 * clusters <= sms                       # one wave
        assert cls.cluster_smem_bytes(hidden, dtype) <= limit
    else:
        assert layout == "wide"
        assert rows == cls.stack_rows(batch, hidden, dtype, sms, limit)
        assert threads == 32 * -(-rows * hidden // 32) <= 1024
    assert cls.STACK_FWD_LAYOUTS[layout] in (0, 1)


def test_stack_fwd_cluster_shared_memory():
    """The cluster layout's blocks: 57,200 B fixed in float32 (50,544 in
    bf16, which keeps one more row in registers), 13 rows of k2 dealt out
    to 416 threads, a staging area for half the recurrent matrix (at least
    13 rows)."""
    assert cls.cluster_smem_bytes(100, torch.float32) == 57_200 + 86_528 + 80_000
    assert cls.cluster_smem_bytes(100, torch.bfloat16) == 50_544 + 43_264 + 40_000
    assert cls.cluster_smem_bytes(8, torch.bfloat16) == 50_544 + 43_264 + 832
    assert cls.cluster_smem_bytes(100, torch.float32) <= cls.HOPPER_SMEM_BYTES
    with pytest.raises(ValueError, match="cluster layout needs"):
        cls.stack_fwd_layout(100, torch.float32, 32, 132, 150_000)


@pytest.mark.parametrize("batch", [1, 64, 133])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [8, 100, 101, 117, 164])
def test_stack_bwd_layout_rule(hidden, dtype, batch):
    """The backward's launch rule on a 132-SM card: the cluster layout (two
    blocks of 416 threads a batch row, ceil(B / 66) rows a cluster) up to
    H=100, the wide layout (``stack_rows`` rows a block, a thread per row
    and unit) above it within ``stack_fits``, as the forward's; a width the
    fused stack refuses raises, and nothing ``stack_fits`` admits does."""
    sms, limit = 132, cls.HOPPER_SMEM_BYTES
    if not cls.stack_fits(hidden, dtype):
        with pytest.raises(ValueError, match="chained route"):
            cls.stack_bwd_layout(hidden, dtype, batch, sms, limit)
        return
    layout, threads, rows = cls.stack_bwd_layout(hidden, dtype, batch, sms, limit)
    assert (layout, threads, rows) == cls.stack_fwd_layout(hidden, dtype, batch, sms, limit)
    clusters = -(-batch // rows)
    if hidden <= 100:
        assert (layout, threads) == ("cluster", 416)
        assert rows == -(-batch // 66) and (clusters - 1) * rows < batch
        assert 2 * clusters <= sms                       # one wave
        assert cls.cluster_bwd_smem_bytes(hidden, dtype) <= limit
    else:
        assert layout == "wide"
        assert rows == cls.stack_rows(batch, hidden, dtype, sms, limit)
        assert threads == 32 * -(-rows * hidden // 32) <= 1024
    assert cls.STACK_FWD_LAYOUTS[layout] in (0, 1)


def test_stack_bwd_cluster_shared_memory():
    """The backward's cluster blocks: 84,912 B fixed (two dz buffers 3,328,
    the staged step inputs 6,656, the 10 chunks past the 15 in registers
    66,560, the ring 8,320, its mbarriers and counter 48), 13 chunks of k2
    dealt out to 416 threads, a staging area for a third of the recurrent
    matrix; within the card's 232,448 B, and a smaller limit raises."""
    assert cls.STACK_BWD_KEEP == {torch.float32: 15, torch.bfloat16: 15}
    assert cls.cluster_bwd_smem_bytes(100, torch.float32) == 84_912 + 86_528 + 54_400
    assert cls.cluster_bwd_smem_bytes(100, torch.bfloat16) == 84_912 + 43_264 + 27_200
    assert cls.cluster_bwd_smem_bytes(9, torch.bfloat16) == 84_912 + 43_264 + 216
    assert cls.cluster_bwd_smem_bytes(100, torch.float32) <= cls.HOPPER_SMEM_BYTES
    with pytest.raises(ValueError, match="cluster layout needs"):
        cls.stack_bwd_layout(100, torch.float32, 32, 132, 200_000)


@pytest.mark.parametrize("batch", [1, 64, 133])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [8, 100, 101, 117, 164])
def test_stack_adj_layout_rule(hidden, dtype, batch):
    """The adjoint's launch rule on a 132-SM card: the cluster layout (a
    pre-pass, two blocks of 416 threads a batch row, ceil(B / 66) rows a
    cluster, a post-pass) up to H=100, the wide layout (``stack_rows`` rows
    a block, a thread per row and unit) above it within ``stack_fits``, the
    same as the forward's and the backward's; a width the fused stack
    refuses raises, and nothing ``stack_fits`` admits does."""
    sms, limit = 132, cls.HOPPER_SMEM_BYTES
    if not cls.stack_fits(hidden, dtype):
        with pytest.raises(ValueError, match="chained route"):
            cls.stack_adj_layout(hidden, dtype, batch, sms, limit)
        return
    layout, threads, rows = cls.stack_adj_layout(hidden, dtype, batch, sms, limit)
    assert (layout, threads, rows) == cls.stack_fwd_layout(hidden, dtype, batch, sms, limit)
    assert (layout, threads, rows) == cls.stack_bwd_layout(hidden, dtype, batch, sms, limit)
    clusters = -(-batch // rows)
    if hidden <= 100:
        assert (layout, threads) == ("cluster", 416)
        assert rows == -(-batch // 66) and (clusters - 1) * rows < batch
        assert 2 * clusters <= sms                       # one wave
        assert cls.cluster_adj_smem_bytes(hidden, dtype) <= limit
    else:
        assert layout == "wide"
        assert rows == cls.stack_rows(batch, hidden, dtype, sms, limit)
        assert threads == 32 * -(-rows * hidden // 32) <= 1024
    assert cls.STACK_FWD_LAYOUTS[layout] in (0, 1)


def test_stack_adj_cluster_shared_memory():
    """The adjoint's cluster blocks: 72,624 B fixed (two h buffers 896, the
    staged step inputs 9,984, the 8 rows past the 17 in registers 53,248,
    the ring 8,448, its mbarriers and counter 48), 13 rows of k2 dealt out
    to 416 threads, a staging area for a third of the recurrent matrix
    (at least 13 rows); within the card's 232,448 B, and a smaller limit
    raises."""
    assert cls.STACK_ADJ_KEEP == {torch.float32: 17, torch.bfloat16: 17}
    assert cls.cluster_adj_smem_bytes(100, torch.float32) == 72_624 + 86_528 + 54_400
    assert cls.cluster_adj_smem_bytes(100, torch.bfloat16) == 72_624 + 43_264 + 27_200
    assert cls.cluster_adj_smem_bytes(9, torch.bfloat16) == 72_624 + 43_264 + 936
    assert cls.cluster_adj_smem_bytes(100, torch.float32) <= cls.HOPPER_SMEM_BYTES
    with pytest.raises(ValueError, match="cluster layout needs"):
        cls.stack_adj_layout(100, torch.float32, 32, 132, 190_000)


def test_stack_wrappers_refuse_and_eligibility_rule():
    xz1, mat = torch.zeros(4, 2, 40), torch.zeros(10, 40)
    b2, seq = torch.zeros(40), torch.zeros(4, 2, 10)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cls.stack_fwd_cuda(xz1, mat, mat, b2, mat)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cls.stack_bwd_cuda(xz1, mat, mat, b2, mat, seq, seq, seq, seq, seq)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cls.stack_adj_cuda(xz1, mat, mat, b2, mat, *[seq] * 8, xz1, mat, mat, b2, mat)
    # rec1 (with the row pad for the sweeps that walk it both ways) plus staging
    assert cls.stack_smem_bytes(100, torch.float32, 1, "stack_fwd") == 160_000 + 1_600
    assert cls.stack_smem_bytes(100, torch.float32, 1, "stack_bwd") == 160_400 + 4_400
    assert cls.stack_smem_bytes(100, torch.float32, 1, "stack_adj") == 160_400 + 8_800
    assert cls.stack_smem_bytes(100, torch.bfloat16, 2, "stack_adj") == 80_208 + 17_600
    assert cls.stack_fits(100, torch.float32) and cls.stack_fits(100, torch.bfloat16)
    assert cls.stack_fits(117, torch.float32) and not cls.stack_fits(118, torch.float32)
    assert cls.stack_fits(164, torch.bfloat16) and not cls.stack_fits(165, torch.bfloat16)
    assert not cls.stack_fits(100, torch.float16)
    assert not cls.stack_fits(100, torch.float32, rows=11)
    # rows per block are cut until the adjoint's staging fits
    assert cls.stack_rows(64, 100, torch.float32, 132, cls.HOPPER_SMEM_BYTES) == 1
    assert cls.stack_rows(4096, 100, torch.float32, 132, cls.HOPPER_SMEM_BYTES) == 8
    with pytest.raises(ValueError, match="chained route"):
        cls.stack_rows(32, 128, torch.float32, 132, cls.HOPPER_SMEM_BYTES)
    cuda_lstm.reset_launches()
    before = cuda_lstm.launch_counts()
    ops = _small_weights(np.random.default_rng(3), 4)
    cls.stack_seq(*ops, "tanh").sum().backward()      # the plain path counts nothing
    assert cuda_lstm.launch_counts() == before
    assert {"stack_fwd", "stack_fwd_res", "stack_bwd", "stack_adj"} <= set(before)
