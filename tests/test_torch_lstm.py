"""The port's LSTM (``hfrep_tpu_torch.ops``) against the JAX package.

Same numpy inputs and params through ``hfrep_tpu.ops.lstm.KerasLSTM``
(the scan path), ``pallas_keras_lstm`` (the Pallas kernel, in interpret
mode on the CPU as tests/test_pallas_lstm.py runs it) and the port's
``KerasLSTM`` on ``device="cpu"`` (the kernel's plain version).  Bars:
f32 atol 1e-5 (the Pallas kernel's own bar against the scan), bf16
atol 3e-2 after scaling by max|ref|.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfrep_tpu.ops.lstm import KerasLSTM as JaxKerasLSTM
from hfrep_tpu.ops.pallas_lstm import pallas_keras_lstm
from hfrep_tpu_torch.ops import cuda_lstm
from hfrep_tpu_torch.ops.lstm import KerasLSTM
from hfrep_tpu_torch.utils.bridge import from_flax

W, B, F = 8, 3, 5
ACTS = ["sigmoid", "tanh", "linear"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _case(h, seed=0):
    """Params at Keras-init scale: the recurrent entries ~ 1/sqrt(H)."""
    g = np.random.default_rng(seed)
    params = {"kernel": (0.4 * g.normal(size=(F, 4 * h))).astype(np.float32),
              "recurrent_kernel": (g.normal(size=(h, 4 * h)) / np.sqrt(h)
                                   ).astype(np.float32),
              "bias": (0.1 * g.normal(size=(4 * h,))).astype(np.float32)}
    x = g.normal(size=(B, W, F)).astype(np.float32)
    return params, x


def _port(params, x, act, dtype=None):
    h = params["recurrent_kernel"].shape[0]
    mod = from_flax(params, KerasLSTM(F, h, activation=act, dtype=dtype,
                                      device="cpu"))
    with torch.no_grad():
        return mod(torch.from_numpy(x)).float().numpy()


def _scaled_close(got, ref, bar=3e-2):
    scale = max(float(np.max(np.abs(ref))), 1e-6)
    np.testing.assert_allclose(got / scale, ref / scale, atol=bar)


@pytest.mark.parametrize("h", [16, 100])
@pytest.mark.parametrize("act", ACTS)
def test_f32_matches_jax_scan_and_pallas(act, h):
    params, x = _case(h)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    scan = np.asarray(JaxKerasLSTM(h, activation=act).apply(
        {"params": jp}, jnp.asarray(x)))
    pallas = np.asarray(pallas_keras_lstm(jp["kernel"], jp["recurrent_kernel"],
                                          jp["bias"], jnp.asarray(x), act))
    got = _port(params, x, act)
    assert got.shape == (B, W, h)
    np.testing.assert_allclose(got, scan, atol=1e-5)
    np.testing.assert_allclose(got, pallas, atol=1e-5)


@pytest.mark.parametrize("act", ACTS)
def test_bf16_matches_jax_scan_and_pallas(act):
    h = 16
    params, x = _case(h, seed=1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    scan = JaxKerasLSTM(h, activation=act, dtype=jnp.bfloat16).apply(
        {"params": jp}, jnp.asarray(x))
    pallas = pallas_keras_lstm(jp["kernel"], jp["recurrent_kernel"], jp["bias"],
                               jnp.asarray(x), act, dtype=jnp.bfloat16)
    mod = from_flax(params, KerasLSTM(F, h, activation=act, dtype=torch.bfloat16,
                                      device="cpu"))
    with torch.no_grad():
        out = mod(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16 and scan.dtype == jnp.bfloat16
    got = out.float().numpy()
    _scaled_close(got, np.asarray(scan, np.float32))
    _scaled_close(got, np.asarray(pallas, np.float32))


def test_plain_version_is_the_dispatch_on_cpu():
    g = np.random.default_rng(2)
    xz = torch.from_numpy((0.5 * g.normal(size=(6, 4, 4 * 12))).astype(np.float32))
    rec = torch.from_numpy((0.3 * g.normal(size=(12, 4 * 12))).astype(np.float32))
    before = cuda_lstm.launches
    hs = cuda_lstm.lstm_seq(xz, rec, "sigmoid")
    assert hs.dtype == torch.float32 and hs.shape == (6, 4, 12)
    assert torch.equal(hs, cuda_lstm.lstm_seq_plain(xz, rec, "sigmoid"))
    assert cuda_lstm.launches == before          # no kernel ran


def test_plain_bf16_rounds_h_before_the_dot():
    """bf16 operand streams: h is rounded to bf16 before the recurrent
    dot, the dot sums exact products in f32, and hs stays f32."""
    g = np.random.default_rng(3)
    xz = torch.from_numpy((0.5 * g.normal(size=(5, 2, 16))).astype(np.float32))
    rec = torch.from_numpy((0.3 * g.normal(size=(4, 16))).astype(np.float32))
    xz16, rec16 = xz.to(torch.bfloat16), rec.to(torch.bfloat16)
    hs = cuda_lstm.lstm_seq_plain(xz16, rec16, "tanh")
    assert hs.dtype == torch.float32
    h = torch.zeros(2, 4)
    c = torch.zeros(2, 4)
    for t in range(5):
        z = xz16[t].float() + h.to(torch.bfloat16).float() @ rec16.float()
        i, f, cc, o = z.split(4, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(cc)
        h = torch.sigmoid(o) * torch.tanh(c)
        torch.testing.assert_close(hs[t], h, atol=1e-6, rtol=0)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    xz = torch.zeros(4, 2, 40)
    rec = torch.zeros(10, 40)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_lstm.lstm_fwd_cuda(xz, rec, "sigmoid")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_lstm.lstm_fwd_cuda(xz.double(), rec.double(), "sigmoid")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_lstm.lstm_fwd_cuda(xz, rec.to(torch.bfloat16), "sigmoid")
    with pytest.raises(ValueError, match="want xz"):
        cuda_lstm.lstm_fwd_cuda(xz, torch.zeros(11, 40), "sigmoid")
    with pytest.raises(ValueError, match="want xz"):
        cuda_lstm.lstm_fwd_cuda(xz[0], rec, "sigmoid")
    with pytest.raises(ValueError, match="contiguous"):
        cuda_lstm.lstm_fwd_cuda(torch.zeros(2, 4, 40).transpose(0, 1), rec, "sigmoid")
    with pytest.raises(NotImplementedError, match="unsupported activation"):
        cuda_lstm.lstm_fwd_cuda(xz, rec, "relu")


def test_keras_entry_refuses_other_gates_and_dtypes():
    x = torch.zeros(1, 2, 3)
    k, r, b = torch.zeros(3, 8), torch.zeros(2, 8), torch.zeros(8)
    with pytest.raises(NotImplementedError, match="sigmoid gates"):
        cuda_lstm.keras_lstm(k, r, b, x, "tanh", recurrent_activation="hard_sigmoid")
    with pytest.raises(NotImplementedError, match="float32/bfloat16"):
        cuda_lstm.keras_lstm(k, r, b, x, "tanh", dtype=torch.float16)


def test_eligibility_rule_from_hopper_limits():
    # H=100 takes the forward's register layout: an h buffer of four
    # 28-float quarters, a z buffer of four 104-float gates and, for each
    # of 416 threads, the 3 of its 25 rows of rec not held in registers,
    # four gates each, all float32; then rec itself (160,000 B in f32,
    # 80,000 B in bf16), staged there once.  H=120 the wide layout, rec
    # (230,400 B in f32) plus h buffers
    own = (4 * 28 + 4 * 104 + (25 - cuda_lstm.FWD_KEEP) * 416 * 4) * 4
    assert cuda_lstm.FWD_KEEP == 22 and own == 22_080
    assert cuda_lstm.smem_bytes(100, torch.float32) == own + 160_000
    assert cuda_lstm.smem_bytes(100, torch.bfloat16) == own + 80_000
    assert cuda_lstm.smem_bytes(120, torch.float32) == 230_400 + 960
    hopper = 232_448
    cuda_lstm.check_fits(100, torch.float32, 1, hopper)
    cuda_lstm.check_fits(160, torch.bfloat16, 1, hopper)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_lstm.check_fits(256, torch.float32, 1, hopper)
    with pytest.raises(ValueError, match="threads a block"):
        cuda_lstm.check_fits(100, torch.float32, 11, hopper)
    assert cuda_lstm.rows_per_block(64, 100, 132) == 1
    assert cuda_lstm.rows_per_block(1000, 100, 132) == 8
    assert cuda_lstm.rows_per_block(100_000, 100, 132) == 10


HOPPER_SMEM, HOPPER_SMS = 232_448, 132


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_layout_at_the_preset_width_is_registers(dtype):
    """H=100 (every preset): a quad of threads per unit, 13 warps (at any
    width the layout takes), rec's k range cut into quarters of KS=25
    rows, one batch row a block up to the SM count and two at B=133."""
    assert cuda_lstm.FWD_KS == 25 and 4 * cuda_lstm.FWD_KS >= 100
    for b, rows in ((1, 1), (8, 1), (32, 1), (64, 1), (132, 1), (133, 2), (1000, 8)):
        assert cuda_lstm.fwd_layout(100, dtype, b, HOPPER_SMS, HOPPER_SMEM) == (
            "registers", 416, rows)
    assert cuda_lstm.fwd_layout(16, dtype, 8, HOPPER_SMS, HOPPER_SMEM) == ("registers", 416, 1)
    # the register layout's shared memory does not grow with the rows
    assert cuda_lstm.smem_bytes(100, dtype, 8) == cuda_lstm.smem_bytes(100, dtype, 1) <= HOPPER_SMEM


def _shared_rule(h, dtype, b):
    """The forward's rule before the register layout: rec and two h
    buffers per row in shared memory, a thread per (row, unit); None if it
    admits (h, dtype, b), else the message it raised."""
    item = torch.empty((), dtype=dtype).element_size()
    rows = cuda_lstm.rows_per_block(b, h, HOPPER_SMS)
    if rows * h > 1024:
        return f"lstm_fwd kernel: {rows} rows x hidden width {h} exceeds 1024 threads a block"
    need = (4 * h * h + 2 * rows * h) * item
    if need > HOPPER_SMEM:
        return (f"lstm_fwd kernel: hidden width {h} in {dtype} needs {need} B of shared "
                f"memory for rec and its buffers; one block of this card may use "
                f"{HOPPER_SMEM} B")
    return None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_layout_admits_what_the_shared_rule_admitted(dtype):
    """Every (H, dtype, B) the shared-memory rule admitted still gets a
    layout (the register one up to H=100, the wide one above), and each
    one it refused raises the same ValueError."""
    admitted = refused = 0
    for h in range(1, 171):
        for b in (1, 8, 32, 64, 133, 1000):
            want = _shared_rule(h, dtype, b)
            if want is None:
                layout, threads, rows = cuda_lstm.fwd_layout(h, dtype, b, HOPPER_SMS,
                                                              HOPPER_SMEM)
                assert layout == ("registers" if h <= 100 else "wide"), (h, b)
                assert threads % 32 == 0 and threads <= 1024 and rows >= 1
                assert threads >= (4 * h if layout == "registers" else rows * h)
                admitted += 1
            else:
                assert h > 100, (h, b)       # the register widths were all admitted
                with pytest.raises(ValueError) as err:
                    cuda_lstm.fwd_layout(h, dtype, b, HOPPER_SMS, HOPPER_SMEM)
                assert str(err.value) == want
                refused += 1
    # f32 admits H <= 120 at B <= 264, bf16 H <= 170 at B <= 132
    assert admitted and refused
    top = max(h for h in range(101, 171) if _shared_rule(h, dtype, 8) is None)
    assert top == (120 if dtype == torch.float32 else 170)


def test_launch_counter_resets():
    cuda_lstm.reset_launches()
    assert cuda_lstm.launches == 0
