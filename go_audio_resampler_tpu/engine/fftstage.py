"""FFT overlap-save lowering for the long-FIR stages (beyond reference).

The reference's ``should_use_fft`` topology exists but its FFT stage
*delegates to polyphase* (``/root/reference/stages.go:114-119``) — no FFT
convolution is ever executed there.  This module implements the real
thing: block-FFT (overlap-save) evaluation of the integer-decimation and
DFT-upsample stages, exact to their time-domain definitions.

When to use: the banded frames-matmul path reads each input sample
``Wx/Ipx`` times (~2.8x for 96k->48k) and spends ``T/M`` MACs per output;
both grow linearly with the prototype length ``T``, while the
overlap-save path reads each input ~once and spends ``O(log N)`` per
sample independent of ``T``.  The decimate routing defaults to the
matmul everywhere reachable (oneshot.DECIM_FFT_MIN_TAPS, override via
GAR_DECIM_FFT_MIN_TAPS); the 1:1 aa-prefilter conv keeps a ~6k-tap
crossover (oneshot.FFT_CONV_MIN_TAPS).  Neither crossover has been
re-measured on the current accelerator (the paired rows are
benchmarks/run_all.py decim_long_*).

Semantics parity (verified by tests/test_fftstage.py against
``engine.oneshot``):

- decimate:  y[j] = sum_t xs[j*M + t] * c[t]          (oneshot.py:355-361)
- dft_up:    u[i*F + p] = sum_tau xext[i+tau] * coeffs[p][tau]
             (stages.prestage_apply), sliced [drop : drop+canonical]

The overlap-save core computes the full correlation stream
``f[i] = sum_t xs[i+t] h[t]`` in hops of ``L = N - T + 1`` valid outputs
per N-point real FFT; the filter spectrum is a trace-time constant.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .plan import EnginePlan
from .stages import gather_windows


def _fft_len(t: int) -> int:
    """FFT size: next power of two giving a hop of at least ~3x taps."""
    n = 1
    while n < 4 * t or n < 4096:
        n *= 2
    return n


def fft_correlate(xs: jax.Array, h: np.ndarray, count: int) -> jax.Array:
    """Overlap-save correlation: f[s, i] = sum_t xs[s, i+t] h[t], i < count.

    ``h`` is a host-side constant; its spectrum is baked into the program.
    """
    t = len(h)
    n = _fft_len(t)
    hop = n - t + 1
    k = -(-count // hop)                      # frames
    need = (k - 1) * hop + n
    if xs.shape[1] < need:
        xs = jnp.pad(xs, ((0, 0), (0, need - xs.shape[1])))
    # correlation(x, h) = convolution(x, reverse(h)); overlap-save keeps
    # the last hop outputs of each N-point circular convolution, which
    # for segment start i0 are conv[i0 + t-1 .. i0 + n-1] = f[i0 .. ].
    hrev = np.zeros(n, dtype=np.float64)
    hrev[:t] = h[::-1]
    H = np.fft.rfft(hrev)
    cplx = jnp.complex128 if xs.dtype == jnp.float64 else jnp.complex64
    Hc = jnp.asarray(H, dtype=cplx)
    starts = jnp.asarray(np.arange(k, dtype=np.int64) * hop,
                         dtype=jnp.int32)
    segs = gather_windows(xs, starts, n)       # [S, K, N]
    G = jnp.fft.rfft(segs, axis=-1) * Hc
    g = jnp.fft.irfft(G, n=n, axis=-1)[:, :, t - 1:]   # [S, K, hop]
    f = g.reshape(xs.shape[0], k * hop)
    return f[:, :count].astype(xs.dtype)


def _fft_decimate(plan: EnginePlan, xs: jax.Array, count: int) -> jax.Array:
    """y[j] = f[j*M] where f is the full correlation with decim_coeffs."""
    m = plan.factor
    f = fft_correlate(xs, np.asarray(plan.decim_coeffs, dtype=np.float64),
                      (count - 1) * m + 1)
    return f[:, ::m][:, :count]


def _upsample_prototype(plan: EnginePlan) -> np.ndarray:
    """Interleave the phase FIRs into the zero-stuffed-domain prototype.

    With xz the factor-F zero-stuffing of xext (xz[iF] = xext[i]) and
    prototype P[p + (T1-1-tau)*F] = coeffs[p][tau], the prestage output is
    u[k] = corr(pad_left(xz, F-1), reverse(P))[k]  — derivation:
    u[k]=sum_tau xext[i+tau] c[p][tau] with k=iF+p, substitute
    xz[(i+tau)F], reindex as a convolution in the stuffed domain, convert
    to correlation by tap reversal and an F-1 left pad.
    """
    f, t1 = plan.factor, plan.pre_taps
    proto = np.zeros(t1 * f, dtype=np.float64)
    for p in range(f):
        for tau in range(t1):
            proto[p + (t1 - 1 - tau) * f] = plan.pre_coeffs[p][tau]
    return proto


def _fft_upsample(plan: EnginePlan, xext: jax.Array, count: int,
                  drop: int) -> jax.Array:
    f = plan.factor
    nz = xext.shape[1] * f
    xz = jnp.zeros((xext.shape[0], nz + f - 1), dtype=xext.dtype)
    xz = xz.at[:, f - 1::f].set(xext)          # left pad F-1 + stuffing
    prot = _upsample_prototype(plan)
    u = fft_correlate(xz, prot[::-1], drop + count)
    return u[:, drop:drop + count]


@partial(jax.jit, static_argnums=(0, 2))
def _fft_oneshot_jit(plan: EnginePlan, x: jax.Array,
                     dtype_name: str) -> jax.Array:
    dtype = jnp.dtype(dtype_name)
    x = x.astype(dtype)
    n = x.shape[1]
    lm = plan.lengths
    canonical = lm.canonical(n)
    if canonical <= 0 or n == 0:
        return jnp.zeros((x.shape[0], max(canonical, 0)), dtype=dtype)
    z = lm.flush_pad(n)

    if plan.kind == 'decimate':
        t = plan.decim_taps
        need = (t - 1) + (canonical - 1) * plan.factor + t
        pad_right = max(z, need - (t - 1 + n))
        xext = jnp.pad(x, ((0, 0), (t - 1, pad_right)))
        return _fft_decimate(plan, xext[:, t - 1:], canonical)

    if plan.kind == 'dft_up':
        t1, f = plan.pre_taps, plan.factor
        if f == 1:
            return x
        xext = jnp.pad(x, ((0, 0), (t1 - 1, z)))
        return _fft_upsample(plan, xext, canonical, lm.drop_prefix())

    raise ValueError(
        "fft_oneshot lowers the long-FIR stages only (kinds 'decimate' "
        f"and 'dft_up'); got {plan.kind!r} — use engine.oneshot, whose "
        "fused matmul serves the polyphase topologies")


def fft_oneshot(plan: EnginePlan, x, dtype=None):
    """One-shot resample via FFT overlap-save (decimate / dft_up plans).

    Drop-in alternative to :func:`engine.oneshot` for the two long-FIR
    topologies; produces the same canonical stream (equality tested at
    float64).
    """
    x = jnp.asarray(x)
    if x.ndim != 2:
        raise ValueError(f"fft_oneshot expects [streams, samples], "
                         f"got {x.shape}")
    dtype = jnp.dtype(dtype or x.dtype)
    return _fft_oneshot_jit(plan, x, dtype.name)
