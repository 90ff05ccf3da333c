"""The weight sums and the single-layer backward's and adjoint's register
layouts, on the CPU.

* The launch rules as pure functions: ``cuda_lstm.sum_splits`` /
  ``sum_plan`` (the weight sums' cluster size, the twin of
  ``csrc/weight_sum.cuh``'s ``splits_for``), ``bwd_layout`` (the
  backward's layout) and ``adj_layout`` (the adjoint's).
* A torch emulation of the weight sums' order — each output tile's k
  range in pieces of WS_K rows (pair 0's rows, then pair 1's, each padded
  to whole pieces), split over the cluster's blocks, each block summing
  its pieces row by row, the blocks' partial tiles added in split order —
  against ``weight_sum_plain`` and against the Pallas kernels' sums in
  interpret mode (``_bwd_call``'s drec, one pair, with and without the
  carry mode's head; ``_adj_call``'s urec, two pairs, with the heads),
  and the column sum (M = 1): atol 1e-5, rtol 1e-4 (urec against the
  Pallas adjoint atol 1e-4, its W-step sum, as the JAX suite allows).
* The backward's register-layout regrouping — every step's gates from one
  product over all W*B rows first (the pre-pass), then the reverse chain
  from them — against ``lstm_bwd_plain`` and the Pallas ``_bwd_kernel`` in
  interpret mode in every mode (plain, dcs, with_carries, carry0 with
  dc_fin, all together): atol 1e-5, rtol 1e-4; in the carry modes the
  atol scaled by max(1, max|ref|), as tests/test_torch_lstm_carry.py holds
  the plain carry backward to the Pallas kernel.
* The adjoint's register-layout regrouping — every step's gates and
  u + h_{t-1} . v from two products over all W*B rows first (the
  pre-pass), then the forward chain adding round(mu_h) . rec, then every
  row's transposed products at once (the post-pass) and urec — against
  ``lstm_adj_plain`` and the Pallas ``_adj_kernel`` in interpret mode, in
  both modes (the carry mode with mu0): atol 1e-5 (urec 1e-4, its W-step
  sum), rtol 1e-4, the carry mode's atol scaled as above.
"""

from __future__ import annotations

import math

import jax
import numpy as np
import pytest
import torch

from hfrep_tpu.ops.pallas_lstm import _adj_call, _bwd_call, _lstm_seq_fwd_impl
from hfrep_tpu_torch.ops import cuda_lstm

ACTS = ["sigmoid", "tanh", "linear"]
W, B, HP = 5, 4, 128
HOPPER_SMEM = 232_448


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, ref, atol=1e-5, rtol=1e-4, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=rtol,
                               err_msg=name)


def _case(activation, carry: bool):
    """The adjoint set-up of tests/test_pallas_lstm.py (w=5, b=4, hp=128),
    with a nonzero (h0, c0) and dc_fin for the carry mode."""
    ks = jax.random.split(jax.random.PRNGKey(7), 6)
    g = 4 * HP
    c = dict(xz=0.3 * jax.random.normal(ks[0], (W, B, g)),
             rec=0.3 * jax.random.normal(ks[1], (HP, g)),
             dhs=0.3 * jax.random.normal(ks[2], (W, B, HP)),
             dcs=0.3 * jax.random.normal(jax.random.fold_in(ks[2], 1), (W, B, HP)),
             u=0.3 * jax.random.normal(ks[3], (W, B, g)),
             v=0.3 * jax.random.normal(jax.random.fold_in(ks[3], 1), (HP, g)))
    carry_j = None
    if carry:
        c.update(h0=0.5 * jax.random.normal(ks[4], (B, HP)),
                 c0=0.5 * jax.random.normal(jax.random.fold_in(ks[4], 1), (B, HP)),
                 dc_fin=0.3 * jax.random.normal(ks[5], (B, HP)),
                 muh0=0.3 * jax.random.normal(jax.random.fold_in(ks[5], 1), (B, HP)),
                 muc0=0.3 * jax.random.normal(jax.random.fold_in(ks[5], 2), (B, HP)))
        carry_j = (c["h0"], c["c0"])
    c["hs"], c["cs"] = _lstm_seq_fwd_impl(c["xz"], c["rec"], activation, with_cs=True,
                                          carry=carry_j)
    return c


# ------------------------------------------------------------ launch rules
def test_sum_split_rule():
    """The most of 16, 8, 4, 2, 1 blocks a tile within WS_BLOCKS_PER_SM
    blocks an SM and WS_MIN_PIECES pieces a block; ``sum_plan`` counts a
    launch's tiles (64 x 64, or WS_COLS columns of a column sum) and pieces
    as ``weight_sum.cuh``'s ``grid_for`` does."""
    assert cuda_lstm.sum_splits(14, 96, 132) == 16
    assert cuda_lstm.sum_splits(14, 31, 132) == 4          # 31 pieces: 4 a block at most 7
    assert cuda_lstm.sum_splits(14, 3, 132) == 1
    assert cuda_lstm.sum_splits(100, 10_000, 132) == 8      # 16 x 100 > 8 x 132
    assert cuda_lstm.sum_splits(600, 10_000, 132) == 1
    assert cuda_lstm.sum_splits(42, 96, 16) == 2
    # the epoch's launches at H=100 on 132 SMs: sixteen blocks a tile each
    for nsum, npair, r, m in ((1, 1, 1536, 100), (3, 1, 1536, 100), (3, 2, 10752, 100),
                              (1, 1, 5376, 1), (1, 2, 3072, 100)):
        tiles, pieces, splits = cuda_lstm.sum_plan(nsum, npair, r, m, 400, 132)
        assert tiles == (7 * nsum if m == 1 else 14 * nsum)
        assert pieces == npair * math.ceil(r / 16)
        assert splits == 16
    assert cuda_lstm.sum_plan(1, 1, 5, 100, 400, 132) == (14, 1, 1)
    assert cuda_lstm.sum_plan(2, 2, 37, 37, 148, 132) == (6, 6, 1)


def test_bwd_layout_rule():
    """The register layout at H <= 4 * FWD_KS, ceil(B / SMs) rows a block;
    the wide layout above under ``check_fits``, which refuses what does not
    fit a block."""
    for dt in (torch.float32, torch.bfloat16):
        for b, rows in ((1, 1), (32, 1), (132, 1), (133, 2), (300, 3)):
            assert cuda_lstm.bwd_layout(100, dt, b, 132, HOPPER_SMEM) == ("registers", 416, rows)
        assert cuda_lstm.bwd_layout(37, dt, 8, 132, HOPPER_SMEM)[0] == "registers"
        assert cuda_lstm.reg_bwd_smem_bytes(100, dt) <= HOPPER_SMEM
    assert cuda_lstm.bwd_layout(117, torch.float32, 133, 132, HOPPER_SMEM) == ("wide", 256, 2)
    assert cuda_lstm.bwd_layout(160, torch.bfloat16, 8, 132, HOPPER_SMEM) == ("wide", 160, 1)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_lstm.bwd_layout(120, torch.float32, 8, 132, HOPPER_SMEM)
    with pytest.raises(ValueError, match="register layout needs"):
        cuda_lstm.bwd_layout(100, torch.float32, 8, 132, 100_000)


def test_adj_layout_rule():
    """The backward's rule with the adjoint's shared memory: the register
    layout at H <= 4 * FWD_KS, ceil(B / SMs) rows a block, in both modes;
    the wide layout above under ``check_fits``, which refuses what does not
    fit a block."""
    for dt in (torch.float32, torch.bfloat16):
        for b, rows in ((1, 1), (32, 1), (132, 1), (133, 2), (300, 3)):
            assert cuda_lstm.adj_layout(100, dt, b, 132, HOPPER_SMEM) == ("registers", 416, rows)
        assert cuda_lstm.adj_layout(37, dt, 8, 132, HOPPER_SMEM)[0] == "registers"
        need = cuda_lstm.reg_adj_smem_bytes(100, dt)
        assert need <= HOPPER_SMEM
        assert cuda_lstm.reg_adj_smem_bytes(37, dt) < need
    assert cuda_lstm.reg_adj_smem_bytes(100, torch.float32) == 117_504
    assert cuda_lstm.adj_layout(117, torch.float32, 133, 132, HOPPER_SMEM) == ("wide", 256, 2)
    assert cuda_lstm.adj_layout(160, torch.bfloat16, 8, 132, HOPPER_SMEM) == ("wide", 160, 1)
    assert cuda_lstm.adj_layout(160, torch.bfloat16, 133, 132, HOPPER_SMEM) == ("wide", 320, 2)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_lstm.adj_layout(120, torch.float32, 8, 132, HOPPER_SMEM)
    with pytest.raises(ValueError, match="lstm_adj kernel: the register layout needs"):
        cuda_lstm.adj_layout(100, torch.float32, 8, 132, 100_000)


# ------------------------------------------------------- the sums' order
def _emulated(terms, shift, splits):
    """``weight_sum.cuh``'s order: the pairs' shifted rows end to end, each
    padded to whole pieces of WS_K rows; block s of the cluster sums its
    pieces row by row; the blocks' tiles added in split order."""
    k = cuda_lstm.WS_K
    r = terms[0][1].shape[0]
    rp = math.ceil(r / k) * k
    a_rows, b_rows = [], []
    for a, b, head in terms:
        if a is None:
            a = torch.ones((r, 1))
        top = head if head is not None else torch.zeros((shift, a.shape[1]))
        pad = torch.zeros((rp - r, a.shape[1]))
        a_rows.append(torch.cat([torch.cat([top, a])[:r], pad]))
        b_rows.append(torch.cat([b, torch.zeros((rp - r, b.shape[1]))]))
    a_all, b_all = torch.cat(a_rows), torch.cat(b_rows)
    pieces = a_all.shape[0] // k
    per = math.ceil(pieces / splits)
    out = None
    for s in range(splits):
        acc = torch.zeros((a_all.shape[1], b_all.shape[1]))
        for row in range(min(s * per, pieces) * k, min((s + 1) * per, pieces) * k):
            acc = acc + a_all[row][:, None] * b_all[row][None, :]
        out = acc if out is None else out + acc
    return out


@pytest.mark.parametrize("splits", [1, 2, 16])
@pytest.mark.parametrize("carry", [False, True])
def test_sum_order_matches_plain_and_pallas_drec(carry, splits):
    c = _case("tanh", carry)
    cj = (c["h0"], c["c0"]) if carry else None
    ref = _bwd_call(c["xz"], c["rec"], c["hs"], c["cs"], c["dhs"], None, "tanh", carry=cj,
                    dc_fin=c["dc_fin"] if carry else None)
    dxz, drec = ref[0], ref[1]
    terms = [(_t(c["hs"]).reshape(W * B, HP), _t(dxz).reshape(W * B, 4 * HP),
              _t(c["h0"]) if carry else None)]
    got = _emulated(terms, B, splits)
    _close(got, cuda_lstm.weight_sum_plain(terms, B), name="vs weight_sum_plain")
    _close(got, drec, name="vs the Pallas kernel's drec")


@pytest.mark.parametrize("splits", [1, 4])
def test_two_pair_order_matches_plain_and_pallas_urec(splits):
    """urec = sum mu_h'^T dz + h'^T zbar: mu_h is udhs moved down a step
    with mu_h0 on top, h is hs with h0 on top (the carry mode's heads)."""
    c = _case("sigmoid", True)
    cj = (c["h0"], c["c0"])
    dxz, _, dhT, dcT, _, _ = _bwd_call(c["xz"], c["rec"], c["hs"], c["cs"], c["dhs"], None,
                                       "sigmoid", with_carries=True, carry=cj,
                                       dc_fin=c["dc_fin"])
    uxz, urec, _, _, udhs, *_ = _adj_call(c["xz"], c["rec"], c["hs"], c["cs"], dhT, dcT,
                                          c["u"], c["v"], "sigmoid", carry=cj,
                                          mu0=(c["muh0"], c["muc0"]))
    rows = lambda x, n: _t(x).reshape(W * B, n)  # noqa: E731
    terms = [(rows(udhs, HP), rows(dxz, 4 * HP), _t(c["muh0"])),
             (rows(c["hs"], HP), rows(uxz, 4 * HP), _t(c["h0"]))]
    got = _emulated(terms, B, splits)
    _close(got, cuda_lstm.weight_sum_plain(terms, B), name="vs weight_sum_plain")
    _close(got, urec, atol=1e-4, name="vs the Pallas adjoint's urec")


@pytest.mark.parametrize("npair", [1, 2])
def test_column_sum_order_matches_plain(npair):
    g = np.random.default_rng(3)
    terms = [(None, _t(g.normal(size=(37, 148))), None) for _ in range(npair)]
    got = _emulated(terms, 0, 2)
    ref = cuda_lstm.weight_sum_plain(terms, 0)
    assert ref.shape == (1, 148)
    _close(got, ref, name="column sum")
    _close(ref[0], sum(b.sum(0) for _, b, _ in terms), name="vs torch.sum")


# ------------------------------------------- the backward's regrouping
def _regrouped_bwd(xz, rec, hs, cs, dhs, dcs, activation, with_carries, carry, dc_fin):
    """The register layout's order of work in plain torch: the pre-pass's
    gates for every step at once, then the reverse chain reading them."""
    code = cuda_lstm.act_code(activation)
    act, p = cuda_lstm._PLAIN_ACT[code], cuda_lstm._PRIME[code]
    w, b, g = xz.shape
    h = g // 4
    rnd = cuda_lstm._rounder(rec)
    h0, c0 = (None, None) if carry is None else carry
    h_prev, c_prev = cuda_lstm._shifted(hs, h0), cuda_lstm._shifted(cs, c0)
    z = xz.float() + (rnd(h_prev).reshape(w * b, h) @ rec.float()).reshape(w, b, g)
    gates = cuda_lstm._gates(z.reshape(w * b, g), h, act)
    ig, fg, gc, og = (x.reshape(w, b, h) for x in gates)
    dxz, dhT, dcT = torch.empty((w, b, g)), torch.empty((w, b, h)), torch.empty((w, b, h))
    dh = torch.zeros((b, h))
    dc = torch.zeros((b, h)) if dc_fin is None else dc_fin.clone()
    for t in reversed(range(w)):
        a_c = act(cs[t])
        dht = dhs[t] + dh
        dct = dc + dht * og[t] * p(a_c)
        if dcs is not None:
            dct = dct + dcs[t]
        dz = torch.cat([dct * gc[t] * ig[t] * (1.0 - ig[t]),
                        dct * c_prev[t] * fg[t] * (1.0 - fg[t]),
                        dct * ig[t] * p(gc[t]), dht * a_c * og[t] * (1.0 - og[t])], dim=-1)
        dxz[t], dhT[t], dcT[t] = dz, dht, dct
        dh, dc = rnd(dz) @ rec.float().T, dct * fg[t]
    drec = cuda_lstm.weight_sum_plain([(hs.reshape(w * b, h), dxz.reshape(w * b, g), h0)], b)
    out = (dxz, drec) + ((dhT, dcT) if with_carries else ())
    return out + ((dh, dc) if carry is not None else ())


@pytest.mark.parametrize("mode", ["plain", "dcs", "with_carries", "carry0", "all"])
@pytest.mark.parametrize("activation", ACTS)
def test_regrouped_bwd_matches_plain_and_pallas(activation, mode):
    carried = mode in ("carry0", "all")
    c = _case(activation, carried)
    dcs = c["dcs"] if mode in ("dcs", "all") else None
    carries = mode in ("with_carries", "all")
    cj = (c["h0"], c["c0"]) if carried else None
    ref = _bwd_call(c["xz"], c["rec"], c["hs"], c["cs"], c["dhs"], dcs, activation,
                    with_carries=carries, carry=cj, dc_fin=c["dc_fin"] if carried else None)
    args = (*(_t(c[k]) for k in ("xz", "rec", "hs", "cs", "dhs")),
            None if dcs is None else _t(dcs), activation, carries,
            (_t(c["h0"]), _t(c["c0"])) if carried else None,
            _t(c["dc_fin"]) if carried else None)
    got = _regrouped_bwd(*args)
    plain = cuda_lstm.lstm_bwd_plain(*args)
    names = (("dxz", "drec") + (("dhT", "dcT") if carries else ())
             + (("dh0", "dc0") if carried else ()))
    assert len(got) == len(plain) == len(ref) == len(names)
    # the carry modes' atol scaled by max(1, max|ref|), as the carry suite
    # (tests/test_torch_lstm_carry.py) holds lstm_bwd_plain to the Pallas kernel
    for name, a, p, r in zip(names, got, plain, ref):
        scale = max(1.0, float(np.abs(np.asarray(r)).max())) if carried else 1.0
        _close(a, p, atol=1e-5 * scale, name=f"{name} vs lstm_bwd_plain")
        _close(a, r, atol=1e-5 * scale, name=f"{name} vs the Pallas kernel")


# -------------------------------------------- the adjoint's regrouping
def _regrouped_adj(xz, rec, hs, cs, dhT, dcT, u, v, activation, carry, mu0):
    """The register layout's order of work in plain torch: the pre-pass's
    gates and base = u + h_{t-1} . v for every step at once, the forward
    chain adding round(mu_h) . rec to the base, then the post-pass's
    transposed products for every row at once, and urec."""
    code = cuda_lstm.act_code(activation)
    w, b, g = xz.shape
    h = g // 4
    rec32 = rec.float()
    rnd = cuda_lstm._rounder(rec)
    h0, c0 = (None, None) if carry is None else carry
    h_prev, c_prev = cuda_lstm._shifted(hs, h0), cuda_lstm._shifted(cs, c0)
    rows = lambda x, n: x.reshape(w * b, n)  # noqa: E731
    z = xz.float() + (rnd(rows(h_prev, h)) @ rec32).reshape(w, b, g)
    base = u + (rows(h_prev, h) @ v).reshape(w, b, g)
    muh0, muc0 = (None, None) if mu0 is None else mu0
    muh = torch.zeros((b, h)) if muh0 is None else muh0
    muc = torch.zeros((b, h)) if muc0 is None else muc0
    uxz, dzs = torch.empty((w, b, g)), torch.empty((w, b, g))
    udhs, ucp, uc = (torch.empty((w, b, h)) for _ in range(3))
    for t in range(w):
        dz, zbar, dhTbar, dcTbar, cpbar, cbar = cuda_lstm._adj_step(
            code, z[t], cs[t], c_prev[t], dhT[t], dcT[t], muc, base[t] + rnd(muh) @ rec32)
        uxz[t], dzs[t], udhs[t], ucp[t], uc[t] = zbar, dz, dhTbar, cpbar, cbar
        muh, muc = dhTbar, dcTbar
    uhp = (rows(dzs, g) @ v.T + rnd(rows(uxz, g)) @ rec32.T).reshape(w, b, h)
    zero = torch.zeros_like(uhp[:1])
    uhs = torch.cat([uhp[1:], zero])
    ucs = uc + torch.cat([ucp[1:], zero])
    urec = cuda_lstm.weight_sum_plain([(rows(udhs, h), rows(dzs, g), muh0),
                                       (rows(hs, h), rows(uxz, g), h0)], b)
    out = (uxz, urec, uhs, ucs, udhs)
    return out if carry is None else out + (muc, uhp[0], ucp[0])


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("activation", ACTS)
def test_regrouped_adj_matches_plain_and_pallas(activation, carried):
    c = _case(activation, carried)
    cj = (c["h0"], c["c0"]) if carried else None
    _, _, dhT, dcT, *_ = _bwd_call(c["xz"], c["rec"], c["hs"], c["cs"], c["dhs"], None,
                                   activation, with_carries=True, carry=cj,
                                   dc_fin=c["dc_fin"] if carried else None)
    mu0 = (c["muh0"], c["muc0"]) if carried else None
    ref = _adj_call(c["xz"], c["rec"], c["hs"], c["cs"], dhT, dcT, c["u"], c["v"], activation,
                    carry=cj, mu0=mu0)
    args = (*(_t(c[k]) for k in ("xz", "rec", "hs", "cs")), _t(dhT), _t(dcT), _t(c["u"]),
            _t(c["v"]), activation, None if cj is None else (_t(cj[0]), _t(cj[1])),
            None if mu0 is None else (_t(mu0[0]), _t(mu0[1])))
    got = _regrouped_adj(*args)
    plain = cuda_lstm.lstm_adj_plain(*args)
    names = ("uxz", "urec", "uhs", "ucs", "udhs") + (("u_dcfin", "uh0", "uc0") if carried else ())
    assert len(got) == len(plain) == len(ref) == len(names)
    for name, a, p, r in zip(names, got, plain, ref):
        scale = max(1.0, float(np.abs(np.asarray(r)).max())) if carried else 1.0
        atol = (1e-4 if name == "urec" else 1e-5) * scale
        _close(a, p, atol=atol, name=f"{name} vs lstm_adj_plain")
        _close(a, r, atol=atol, name=f"{name} vs the Pallas kernel")
