"""Traced (jit-able) stage kernels with static shapes.

Accelerator-side redesign of the reference's per-sample streaming loops
(SURVEY.md section 7): every stage is a pure function
``(state, x_block) -> (state', y_block, valid)`` over fixed-size blocks
with a leading batch ("streams") axis.  The serial fixed-point phase walk
of the reference polyphase stage (polyphase_stage.go:257-293) is replaced
by its closed form ``at_j = at_0 + j*step`` evaluated in parallel with
two-limb int32 arithmetic (no int64 needed on device), and the inner
convolutions become XLA convolutions / gather+einsum matmuls.

Alignment trick: the prestage keeps a zero-initialized carry of T1-1
samples, so its output stream ``u`` is the reference's pre-stage output
*prefixed by its convolution ramp* of ``(T1-1)*factor`` samples.  The
polyphase accumulator therefore starts at ``at0 = (T1-1)*factor * L << 16``
(plan.at0) instead of 0, which lands its output grid exactly on the
reference's sample positions — output values match the reference
bit-for-bit in exact arithmetic with no transient to drop.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..ops import lowering
from ..ops.convolve import conv1d_poly
from ..ops.precision import dot_precision

I32 = jnp.int32


# ---------------------------------------------------------------------------
# Fixed-point phase walks (closed form, two-limb int32)
# ---------------------------------------------------------------------------

def walk16(at_hi, at_lo, q: int, s_lo: int, count: int):
    """Closed-form 16-bit-fraction walk: at_j = at + j*step, j < count.

    ``at_hi`` is the accumulator's integer part (phase units, = at >> 16),
    ``at_lo`` its 16-bit fraction.  step = q*2^16 + s_lo.  Returns
    (hi[count], frac[count]) as int32.  Safe for count*s_lo < 2^31 and
    count*q + at_hi < 2^31.
    """
    j = lax.iota(I32, count)
    lo = at_lo + j * I32(s_lo)
    carry = lo >> 16
    frac = lo & 0xFFFF
    hi = at_hi + j * I32(q) + carry
    return hi, frac


def walk32(at_int, at_f1, at_f0, q: int, s_f1: int, s_f0: int, count: int,
           dtype=jnp.float32):
    """Closed-form 32-bit-fraction walk with two 16-bit fraction limbs.

    step = q*2^32 + s_f1*2^16 + s_f0.  Returns (i[count], x[count]) where
    ``i`` is the integer part and ``x`` the fraction in [0, 1) in ``dtype``.
    """
    j = lax.iota(I32, count)
    l0 = at_f0 + j * I32(s_f0)
    c0 = l0 >> 16
    r0 = l0 & 0xFFFF
    l1 = at_f1 + j * I32(s_f1) + c0
    c1 = l1 >> 16
    r1 = l1 & 0xFFFF
    i = at_int + j * I32(q) + c1
    x = (r1.astype(dtype) +
         r0.astype(dtype) * (1.0 / 65536.0)) * (1.0 / 65536.0)
    return i, x


def _advance16(at_hi, at_lo, q: int, s_lo: int, n):
    """Advance a 16-bit-fraction accumulator by n steps."""
    lo = at_lo + n * I32(s_lo)
    return at_hi + n * I32(q) + (lo >> 16), lo & 0xFFFF


def _advance32(at_int, at_f1, at_f0, q: int, s_f1: int, s_f0: int, n):
    l0 = at_f0 + n * I32(s_f0)
    l1 = at_f1 + n * I32(s_f1) + (l0 >> 16)
    return at_int + n * I32(q) + (l1 >> 16), l1 & 0xFFFF, l0 & 0xFFFF


# ---------------------------------------------------------------------------
# Stage states (pytrees)
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PrestageState:
    carry: jax.Array        # [S, T1-1] trailing input samples (zeros-init)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PolyState:
    hist: jax.Array         # [S, H] packed unconsumed u-stream
    hist_len: jax.Array     # int32 scalar
    at_hi: jax.Array        # int32 scalar (phase units = at >> 16)
    at_lo: jax.Array        # int32 scalar (16-bit fraction)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DecimState:
    carry: jax.Array        # [S, T-1]
    next_rel: jax.Array     # int32: next output position relative to block


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CubicState:
    carry: jax.Array        # [S, 3]
    at_int: jax.Array       # int32
    at_f1: jax.Array        # int32 (upper 16 fraction bits)
    at_f0: jax.Array        # int32 (lower 16 fraction bits)


# ---------------------------------------------------------------------------
# Prestage: integer-factor polyphase FIR upsampling (dft_stage.go:156-338)
# ---------------------------------------------------------------------------

def prestage_apply(coeffs: jax.Array, xext: jax.Array, factor: int,
                   precision: str = 'auto') -> jax.Array:
    """u[s, i*F + p] = dot(xext[s, i:i+T1], coeffs[p]) for all valid i.

    ``coeffs`` [F, T1] are tap-reversed (design time), so this correlation
    is the reference's polyphase convolution.  Lowered by XLA as a strided
    convolution (matmul-eligible).  ``precision`` pins the matmul tier per
    call site ('auto' = the process-global GAR_TPU_MATMUL_PRECISION).
    """
    from ..ops.convolve import conv1d_poly_interleaved

    del factor  # implied by coeffs.shape[0]
    return conv1d_poly_interleaved(xext, coeffs, precision)


def prestage_process(coeffs: jax.Array, state: PrestageState, x: jax.Array,
                     factor: int, precision: str = 'auto'):
    """Streaming prestage step: [S, B] in -> [S, F*B] out, carry T1-1."""
    xext = jnp.concatenate([state.carry.astype(x.dtype), x], axis=1)
    u = prestage_apply(coeffs, xext, factor, precision)
    t1 = coeffs.shape[1]
    new_carry = xext[:, xext.shape[1] - (t1 - 1):]
    return PrestageState(carry=new_carry), u


# ---------------------------------------------------------------------------
# 1:1 FIR stage (strict-antialias prefilter; beyond reference)
# ---------------------------------------------------------------------------

def fir_process(coeffs: jax.Array, carry: jax.Array, x: jax.Array,
                precision: str = 'auto'):
    """Causal streaming FIR: [S, B] in -> [S, B] out, carry T-1 samples.

    ``coeffs`` [T] is the correlation kernel (symmetric for the linear-
    phase prefilter, so convolution == correlation).  Output i is the
    causal filtered stream c_i = sum_t coeffs[t] * (0^{T-1} ++ x)[i + t];
    the wrapper drops the first (T-1)/2 outputs to realize the
    delay-compensated 'same' filtering the one-shot path uses.
    """
    xext = jnp.concatenate([carry.astype(x.dtype), x], axis=1)
    y = conv1d_poly(xext, coeffs[None, :].astype(x.dtype), stride=1,
                    precision=precision)[:, 0, :]
    return xext[:, x.shape[1]:], y

def poly_coeff_matrix(banks, phase: jax.Array, x: jax.Array) -> jax.Array:
    """Interpolated coefficient rows: A[p] + x*(B[p] + x*(C[p] + x*D[p])).

    ``banks`` = (A, B, C, D) each [L, T2]; phase [C], x [C] -> [C, T2].
    Reference parity: ops.CubicInterpDot's coefficient evaluation
    (simdops/ops.go:46-49) hoisted out of the dot product.
    """
    A, B, C, D = banks
    a = jnp.take(A, phase, axis=0)
    b = jnp.take(B, phase, axis=0)
    c = jnp.take(C, phase, axis=0)
    d = jnp.take(D, phase, axis=0)
    xx = x[:, None].astype(A.dtype)
    return a + xx * (b + xx * (c + xx * d))


def gather_windows(signal: jax.Array, starts: jax.Array, width: int) -> jax.Array:
    """windows[s, c, t] = signal[s, starts[c] + t]  (clipped gather)."""
    idx = starts[:, None] + lax.iota(I32, width)[None, :]
    idx = jnp.clip(idx, 0, signal.shape[1] - 1)
    return jnp.take(signal, idx, axis=1)


#: outputs per banded-emit tile
POLY_EMIT_TILE = 256


def _poly_emit_banded(banks, hist, div, phase, x, taps: int, span: int,
                      tv: int, precision: str = 'auto'):
    """Banded-tile lowering of the polyphase emit (accelerator float32).

    Same trick as the one-shot tile matrices (oneshot._general_matrices)
    and the variable-rate scan (variable._vr_scan), but the operator is
    assembled ON DEVICE because the walk state is runtime data: per tile
    of ``tv`` outputs the windows span at most ``span`` input samples, so
    each output's interpolated coefficient row (poly_coeff_matrix) is
    placed at its window offset inside a [tv, span] banded block via a
    sum of ``taps`` statically-shifted one-hot compare/selects (NOT a
    take_along_axis — see the inline note), one wide slab is gathered
    per TILE (instead of one window per OUTPUT), and the emit becomes a
    per-tile matmul ``[S, span] x [span, tv]``.  MACs on structural
    zeros (~span/taps overhead) buy the removal of the S*cap*taps
    per-output gather.
    """
    cap = div.shape[0]
    n_t = cap // tv
    K = poly_coeff_matrix(banks, phase, x)                   # [cap, T2]
    div_r = div.reshape(n_t, tv)
    i0 = div_r[:, 0]                                         # [n_t]
    rel = div_r - i0[:, None]                                # [n_t, tv]
    # b[t, c, w] = K[t, c, w - rel[t, c]] for 0 <= w - rel < taps else 0.
    # Built as sum_j K[..., j] * 1[w == rel + j]: per (t, c, w) exactly
    # one term is nonzero, so the result is bit-identical to an indexed
    # placement — but each term is an elementwise COMPARE against a
    # broadcast scalar instead of a per-element take_along_axis gather.
    # XLA fuses the taps-term sum into one elementwise pass over b.
    Kf = K.reshape(n_t, tv, taps).astype(hist.dtype)
    iw = lax.iota(I32, span)[None, None, :]                  # [1, 1, span]
    shifted = iw - rel[..., None]                            # [n_t, tv, span]
    b = jnp.zeros((n_t, tv, span), hist.dtype)
    for jtap in range(taps):
        b = b + jnp.where(shifted == jtap, Kf[:, :, jtap, None], 0.0)
    slab = gather_windows(hist, i0, span)                    # [S, n_t, span]
    y = jnp.einsum('stw,tcw->stc', slab, b,
                   preferred_element_type=hist.dtype,
                   precision=dot_precision(precision))
    return y.reshape(hist.shape[0], cap)


def poly_emit(banks, hist: jax.Array, hist_len, at_hi, at_lo,
              num_phases: int, taps: int, step_hi: int, step_lo: int,
              cap: int, out_tile: int = 0, precision: str = 'auto'):
    """Emit up to ``cap`` polyphase outputs from the packed history.

    Returns (y[S, cap], valid[cap], n_out, at_hi', at_lo') where the valid
    outputs are left-packed (valid is monotone).  The emitted values equal
    the reference walk's outputs exactly (same windows, same interpolated
    coefficients); the banded-tile lowering (float32 where
    ``ops.lowering.banded_poly_emit``) changes only the float
    accumulation order.
    """
    L = num_phases
    hi, frac = walk16(at_hi, at_lo, step_hi, step_lo, cap)
    num_in = hist_len - taps + 1
    valid = hi < num_in * L
    div = hi // L
    phase = hi - div * L
    x = frac.astype(hist.dtype) * (1.0 / 65536.0)

    if (hist.dtype == jnp.float32 and cap >= 128
            and lowering.banded_poly_emit()):
        tv = POLY_EMIT_TILE if cap >= POLY_EMIT_TILE else 128
        pad = -cap % tv
        # Static span bound: over k < tv outputs the accumulator's
        # integer part advances by at most (tv-1)*step_hi + (tv-1)
        # (16-bit carry), so the window starts move < that // L + 1.
        div_adv = ((tv - 1) * (step_hi + 1)) // L + 1
        span = -(-(div_adv + taps) // 128) * 128
        div_p = jnp.pad(div, (0, pad), mode='edge')
        phase_p = jnp.pad(phase, (0, pad), mode='edge')
        x_p = jnp.pad(x, (0, pad), mode='edge')
        y = _poly_emit_banded(banks, hist, div_p, phase_p, x_p,
                              taps, span, tv, precision)[:, :cap]
    else:
        def tile_fn(args):
            div_t, phase_t, x_t = args
            K = poly_coeff_matrix(banks, phase_t, x_t)      # [tile, T2]
            w = gather_windows(hist, div_t, taps)           # [S, tile, T2]
            return jnp.einsum('sct,ct->sc', w, K.astype(hist.dtype),
                              preferred_element_type=hist.dtype,
                              precision=dot_precision(precision))

        if out_tile and cap > out_tile and cap % out_tile == 0:
            n_tiles = cap // out_tile
            div_r = div.reshape(n_tiles, out_tile)
            phase_r = phase.reshape(n_tiles, out_tile)
            x_r = x.reshape(n_tiles, out_tile)
            y = lax.map(tile_fn, (div_r, phase_r, x_r))     # [n_t, S, tile]
            y = jnp.transpose(y, (1, 0, 2)).reshape(hist.shape[0], cap)
        else:
            y = tile_fn((div, phase, x))

    y = y * valid.astype(y.dtype)[None, :]
    n_out = valid.astype(I32).sum(dtype=I32)
    at_hi2, at_lo2 = _advance16(at_hi, at_lo, step_hi, step_lo, n_out)
    return y, valid, n_out, at_hi2, at_lo2


def poly_process(banks, state: PolyState, u: jax.Array, num_phases: int,
                 taps: int, step_hi: int, step_lo: int, cap: int,
                 precision: str = 'auto'):
    """Streaming polyphase step: append u, emit, consume, rebase."""
    m = u.shape[1]
    hist = lax.dynamic_update_slice(state.hist, u.astype(state.hist.dtype),
                                    (I32(0), state.hist_len))
    hist_len = state.hist_len + I32(m)
    y, valid, n_out, at_hi, at_lo = poly_emit(
        banks, hist, hist_len, state.at_hi, state.at_lo,
        num_phases, taps, step_hi, step_lo, cap, precision=precision)
    consumed = jnp.minimum(at_hi // I32(num_phases), hist_len)
    hist = jnp.roll(hist, -consumed, axis=1)
    new_state = PolyState(hist=hist, hist_len=hist_len - consumed,
                          at_hi=at_hi - consumed * I32(num_phases),
                          at_lo=at_lo)
    return new_state, y, valid, n_out


# ---------------------------------------------------------------------------
# Decimation stage (dft_stage.go:488-553)
# ---------------------------------------------------------------------------

def decim_process(coeffs: jax.Array, state: DecimState, x: jax.Array,
                  factor: int, precision: str = 'auto'):
    """Streaming decimation: strided FIR at absolute positions next_rel + j*M.

    The carry holds T-1 zero-initialized samples and ``next_rel`` starts at
    T-1, so emitted windows contain only real samples and values equal the
    reference's (window at absolute position p reads (0^{T-1} x)[p : p+T],
    and p >= T-1 <=> the reference's filtered position p-(T-1)).
    """
    m = factor
    t = coeffs.shape[0]
    b = x.shape[1]
    s = x.shape[0]
    histbuf = jnp.concatenate([state.carry.astype(x.dtype), x], axis=1)  # [S, T-1+B]
    cap = (b + m - 1) // m + 1
    r = jnp.remainder(state.next_rel, I32(m))
    lw = (cap - 1) * m + t
    padded = jnp.concatenate(
        [histbuf, jnp.zeros((s, 2 * m + 1), dtype=x.dtype)], axis=1)
    window = lax.dynamic_slice(padded, (I32(0), r), (s, lw))
    out = conv1d_poly(window, coeffs[None, :], stride=m,
                      precision=precision)[:, 0, :]  # [S, cap]
    pos = r + lax.iota(I32, cap) * I32(m)
    valid = (pos >= state.next_rel) & (pos < I32(b))
    k0 = (state.next_rel - r) // I32(m)
    n_out = valid.astype(I32).sum(dtype=I32)
    y = jnp.roll(out * valid.astype(out.dtype)[None, :], -k0, axis=1)
    valid_packed = jnp.roll(valid, -k0)
    new_state = DecimState(carry=histbuf[:, b:],
                           next_rel=state.next_rel + n_out * I32(m) - I32(b))
    return new_state, y, valid_packed, n_out


# ---------------------------------------------------------------------------
# Cubic stage (cubic.go:33-90) with exact 32-bit fixed-point walk
# ---------------------------------------------------------------------------

def hermite4(w: jax.Array, x: jax.Array) -> jax.Array:
    """SOXR cr-core.c 4-point cubic: w [S, C, 4], x [C] -> [S, C].

    s[-1]=w[...,0], s[0]=w[...,1], s[1]=w[...,2], s[2]=w[...,3];
    b = 0.5*(s1+s_m1) - s0; a = (1/6)*(s2-s1+s_m1-s0-4b); c = s1-s0-a-b;
    y = ((a*x + b)*x + c)*x + s0.  (cubic.go:75-90)
    """
    sm1, s0, s1, s2 = w[..., 0], w[..., 1], w[..., 2], w[..., 3]
    b = 0.5 * (s1 + sm1) - s0
    a = (1.0 / 6.0) * (s2 - s1 + sm1 - s0 - 4.0 * b)
    c = s1 - s0 - a - b
    xx = x[None, :].astype(w.dtype)
    return ((a * xx + b) * xx + c) * xx + s0


def linear2(w: jax.Array, x: jax.Array) -> jax.Array:
    """2-point linear interpolation: w [S, C, 2], x [C] -> [S, C].

    Counterpart of the reference's LinearStage kernel (cubic.go:158-183):
    y = (1-x)*prev + x*current.  Faster but lower quality than cubic; kept
    for capability parity (the planner never selects it, matching the
    reference where LinearStage is unused by the planner).
    """
    prev, cur = w[..., 0], w[..., 1]
    xx = x[None, :].astype(w.dtype)
    return (1.0 - xx) * prev + xx * cur


def linear_process(state: CubicState, x: jax.Array, cubic_step: int, cap: int):
    """Streaming linear-interpolation step (LinearStage, cubic.go:141-229).

    Shares CubicState (the 3-sample carry is wider than the 1 sample
    needed; the walk and bookkeeping are identical to the cubic stage).
    """
    b = x.shape[1]
    histbuf = jnp.concatenate([state.carry.astype(x.dtype), x], axis=1)
    q = cubic_step >> 32
    s_f1 = (cubic_step >> 16) & 0xFFFF
    s_f0 = cubic_step & 0xFFFF
    i, frac = walk32(state.at_int, state.at_f1, state.at_f0, q, s_f1, s_f0,
                     cap, dtype=x.dtype)
    valid = i < I32(b)
    # window [prev, cur] = histbuf[i+2 : i+4] (carry width 3 keeps layout)
    w = gather_windows(histbuf, jnp.clip(i, 0, b - 1) + I32(2), 2)
    y = linear2(w, frac.astype(x.dtype))
    y = y * valid.astype(y.dtype)[None, :]
    n_out = valid.astype(I32).sum(dtype=I32)
    at_int, at_f1, at_f0 = _advance32(
        state.at_int, state.at_f1, state.at_f0, q, s_f1, s_f0, n_out)
    new_state = CubicState(carry=histbuf[:, b:], at_int=at_int - I32(b),
                           at_f1=at_f1, at_f0=at_f0)
    return new_state, y, valid, n_out


def cubic_process(state: CubicState, x: jax.Array, cubic_step: int, cap: int):
    """Streaming cubic interpolation step over a fixed block."""
    b = x.shape[1]
    histbuf = jnp.concatenate([state.carry.astype(x.dtype), x], axis=1)  # [S, B+3]
    q = cubic_step >> 32
    s_f1 = (cubic_step >> 16) & 0xFFFF
    s_f0 = cubic_step & 0xFFFF
    i, frac = walk32(state.at_int, state.at_f1, state.at_f0, q, s_f1, s_f0,
                     cap, dtype=x.dtype)
    valid = i < I32(b)
    w = gather_windows(histbuf, jnp.clip(i, 0, b - 1), 4)    # [S, cap, 4]
    y = hermite4(w, frac.astype(x.dtype))
    y = y * valid.astype(y.dtype)[None, :]
    n_out = valid.astype(I32).sum(dtype=I32)
    at_int, at_f1, at_f0 = _advance32(
        state.at_int, state.at_f1, state.at_f0, q, s_f1, s_f0, n_out)
    new_state = CubicState(carry=histbuf[:, b:], at_int=at_int - I32(b),
                           at_f1=at_f1, at_f0=at_f0)
    return new_state, y, valid, n_out
