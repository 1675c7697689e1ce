"""The chunked design of the SSD kernel (``csrc/ssd.cu``), on the CPU.

A float32 PyTorch emulation of the kernel's decomposition: chunks of the
kernel's ``CHUNK`` steps (the ragged tail zero-filled: dt = 0, x = 0,
b = c = 0), the scores ``G = C B^T`` formed once per (batch, group, chunk)
and read by every head of the group, ``x dt`` formed before the products,
the decays ``2^(cum_i - cum_j)`` formed where i >= j only from ``cum``
(in log2 units) summed in float64 and kept as a float32 pair (hi, lo),
the (N, P) state carried across chunks, and every product in 3xTF32 with
the kernel's split emulated on the float32 bits: ``big`` the value with
its 13 low mantissa bits cut, ``small = v - big`` read by the tensor cores
with its own 13 low bits ignored, ``big*small + small*big + big*big``. It
must stay within ``TOL_RECUR_SEQ`` (``chip_smoke.py``'s tolerance of the
kernel against the sequential recurrence, relative to the output's max)
of ``ref.ssd_ref`` and of the JAX package's Pallas ``ssd`` in interpret
mode; the same emulation with plain TF32 products (rounded to nearest, as
``cvt.rna.tf32.f32``) must miss it, which is why the kernel splits.
``ssd.layout`` (grid and scratch of the scores from the shapes alone) is
held at zamba2's training shape.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref
from repro_torch.kernels import ssd as sk

torch.set_num_threads(1)

TOL_RECUR_SEQ = 2e-5
Q = sk.CHUNK


LOG2E = 1.4426950408889634


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on float32 bits (as in test_torch_tf32x3)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_cut(a: torch.Tensor) -> torch.Tensor:
    """The 13 low mantissa bits cut: the kernel's ``big``, and what the
    tensor cores read of a float32 operand."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_big, b_big = tf32_cut(a), tf32_cut(b)
    a_small, b_small = tf32_cut(a - a_big), tf32_cut(b - b_big)
    return (a_big @ b_small + a_small @ b_big) + a_big @ b_big


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32_rna(a) @ tf32_rna(b)


def cum_pair(da: torch.Tensor):
    """Inclusive sums of ``da`` (float32, steps last) in float64, in log2
    units, as the float32 pair (hi, lo) the kernel keeps."""
    cum = torch.cumsum(da.double(), dim=-1) * LOG2E
    hi = cum.float()
    return hi, (cum - hi.double()).float()


def emulate(x, dt, a, b, c, mm=mm_tf32x3):
    """The kernel's chunked scan: x (B, S, H, P), dt (B, S, H), a (H,),
    b/c (B, S, G, N) float32. Returns y (B, S, H, P)."""
    bb, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    nc = -(-s // Q)

    def pad(t):
        return torch.cat([t, t.new_zeros((bb, nc * Q - s) + t.shape[2:])], 1)

    x, dt, b, c = (pad(t) for t in (x, dt, b, c))
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    state = x.new_zeros(bb, h, n, p)
    ys = []
    for ch in range(nc):
        sl = slice(ch * Q, (ch + 1) * Q)
        b_c = b[:, sl].permute(0, 2, 1, 3)             # (B, G, Q, N)
        c_c = c[:, sl].permute(0, 2, 1, 3)
        scores = mm(c_c, b_c.transpose(-1, -2))        # once per group
        scores = scores.repeat_interleave(rep, dim=1)  # (B, H, Q, Q)
        b_h = b_c.repeat_interleave(rep, dim=1)
        c_h = c_c.repeat_interleave(rep, dim=1)
        x_c = x[:, sl].permute(0, 2, 1, 3)             # (B, H, Q, P)
        dt_c = dt[:, sl].permute(0, 2, 1)              # (B, H, Q)
        hi, lo = cum_pair(dt_c * a[None, :, None])
        rel = ((hi[..., :, None] - hi[..., None, :])
               + (lo[..., :, None] - lo[..., None, :]))
        decay = torch.exp2(rel.masked_fill(~tri, -math.inf))
        xdt = x_c * dt_c[..., None]
        y = mm(scores * decay, xdt)
        if ch > 0:
            y = torch.exp2(hi + lo)[..., None] * mm(c_h, state) + y
        ys.append(y.permute(0, 2, 1, 3))
        if ch + 1 < nc:
            to_end = torch.exp2((hi[..., -1:] - hi) + (lo[..., -1:] - lo))
            state = (torch.exp2(hi[..., -1] + lo[..., -1])[..., None, None]
                     * state + mm((b_h * to_end[..., None]).transpose(-1, -2),
                                  xdt))
    return torch.cat(ys, dim=1)[:, :s]


def sequential(x, dt, a, b, c):
    bb, s, h, p = x.shape
    rep = h // b.shape[2]
    bf, cf = (t.repeat_interleave(rep, 2).transpose(1, 2).reshape(
        bb * h, s, -1) for t in (b, c))
    y = ref.ssd_ref(x.transpose(1, 2).reshape(bb * h, s, p),
                    dt.transpose(1, 2).reshape(bb * h, s), a.repeat(bb),
                    bf, cf)
    return y.reshape(bb, h, s, p).transpose(1, 2)


def inputs(b, s, h, g, seed, dt_scale=None):
    """As ``chip_smoke.check_ssd`` draws them (dt the softplus of a standard
    normal, a = -exp(0.3 N(0, 1))); with ``dt_scale`` as
    ``tests/test_torch_recurrent.py`` draws large steps (|N(0, 1)| x
    dt_scale, a = -|N(0, 1)|), whose sums pass float32's exponent range."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, 64)).astype(np.float32)
    if dt_scale is None:
        dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))
        a = -np.exp(0.3 * rng.standard_normal(h))
    else:
        dt = np.abs(rng.standard_normal((b, s, h))) * dt_scale
        a = -np.abs(rng.standard_normal(h))
    bb, cc = (rng.standard_normal((b, s, g, 64)).astype(np.float32)
              for _ in range(2))
    return x, dt.astype(np.float32), a.astype(np.float32), bb, cc


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-12)


CASES = [(2, 1, 2, 1, None), (1, 33, 4, 2, None), (2, 70, 3, 1, None),
         (2, 128, 4, 1, None), (1, 257, 4, 2, None), (1, 200, 2, 1, 4.0)]


@pytest.mark.parametrize("b,s,h,g,dt_scale", CASES)
def test_emulation_within_tolerance_of_the_recurrence(b, s, h, g, dt_scale):
    arrays = inputs(b, s, h, g, s + h + g, dt_scale)
    ts = [torch.as_tensor(t) for t in arrays]
    y = emulate(*ts)
    assert y.shape == (b, s, h, 64) and bool(torch.isfinite(y).all())
    assert _rel(y, sequential(*ts)) < TOL_RECUR_SEQ
    y_j = jops.ssd_forward(*map(jnp.asarray, arrays), chunk=Q,
                           use_pallas="interpret")
    assert _rel(y, y_j) < TOL_RECUR_SEQ


def test_large_steps_pass_the_exponent_range_and_stay_finite():
    """dt x 4: a chunk's log-decay sums pass -88.7, where exp of the
    reference's masked exponent overflows; the kernel's form never takes
    an exponent above the diagonal and stays within tolerance."""
    x, dt, a, b, c = (torch.as_tensor(t)
                      for t in inputs(1, 200, 2, 1, 5, dt_scale=4.0))
    hi, lo = cum_pair(dt[0, :Q].T * a[:, None])
    assert float((hi + lo).min()) / LOG2E < -88.7
    assert bool(torch.isinf(torch.exp2(-(hi + lo))).any())  # above it
    y = emulate(x, dt, a, b, c)
    assert bool(torch.isfinite(y).all())
    assert _rel(y, sequential(x, dt, a, b, c)) < TOL_RECUR_SEQ


@pytest.mark.parametrize("s,g", [(128, 1), (257, 2)])
def test_plain_tf32_products_miss_the_tolerance(s, g):
    """The same decomposition with each product in plain TF32 (a 10-bit
    mantissa, rounded to nearest) lands an order of magnitude and more past
    TOL_RECUR_SEQ."""
    ts = [torch.as_tensor(t) for t in inputs(2, s, 4, g, 11)]
    y_seq = sequential(*ts)
    assert _rel(emulate(*ts, mm=mm_tf32), y_seq) > 10 * TOL_RECUR_SEQ
    assert _rel(emulate(*ts), y_seq) < TOL_RECUR_SEQ


def test_cum_pair_keeps_the_differences_of_large_sums():
    """Differences of neighbouring cumulative sums near -400 (-580 in log2
    units): the pair's (hi_i - hi_j) + (lo_i - lo_j) keeps them to float32
    rounding of the difference itself; one float32 cumsum loses |cum| x
    6e-8."""
    rng = np.random.default_rng(3)
    da = torch.as_tensor(-np.abs(rng.standard_normal(Q)).astype(
        np.float32) * 6.0)
    exact = np.cumsum(da.double().numpy()) * LOG2E
    hi, lo = cum_pair(da)
    diff = ((hi[1:] - hi[:-1]) + (lo[1:] - lo[:-1])).double().numpy()
    want = np.diff(exact)
    assert exact[-1] < -300
    assert np.abs(diff - want).max() <= 4e-7 * np.abs(want).max()
    single = (torch.cumsum(da, 0) * LOG2E).double().numpy()
    assert np.abs(np.diff(single) - want).max() > 5 * np.abs(
        diff - want).max()


def test_layout_at_zamba2_and_ragged_shapes():
    """Two blocks of the scan on each of the H100's 132 SMs at zamba2's
    training shape (B 8, S 128, H 112, G 1), and one scratch tile of the
    scores per (batch, group, chunk, tile of the triangle)."""
    lay = sk.layout(8, 128, 112, 1)
    assert lay.chunks == 1 and lay.scan_blocks == 8 * 56
    assert lay.scan_blocks >= 2 * 132
    assert lay.score_blocks == 8 * 4
    assert lay.scratch_floats == 8 * sk.SCORE_TILES * 32 * 4
    assert sk.SCORE_TILES == sum(2 * (r + 1) for r in range(Q // 16))
    lay = sk.layout(2, 257, 8, 2)
    assert lay.chunks == 3 and lay.scan_blocks == 2 * 2 * 2
    assert lay.scratch_floats == 2 * 2 * 3 * sk.SCORE_TILES * 128
    lay = sk.layout(1, 33, 6, 2)                      # three heads a group
    assert lay.scan_blocks == 2 * 2
