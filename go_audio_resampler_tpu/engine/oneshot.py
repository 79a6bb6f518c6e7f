"""One-shot resampling as a single static XLA program.

For a known input length everything is compile-time constant: the flush
padding, the canonical output length, and the entire fixed-point phase walk
(div/phase/frac per output) — computed host-side in exact numpy int64 and
baked into the program as constants.  The device program is then just
convolutions, gathers and (for exact rational ratios) one big
frames-matmul.

This is the accelerator-side replacement for the reference's
``ResampleMono``/``resampleAll`` call stack (convenience.go:204-229,
SURVEY.md section 3.3), producing the same canonical sample stream.
"""

from __future__ import annotations

import math
import os
from collections import OrderedDict
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..filterdesign.params import PHASE_FRAC_BITS
from ..ops.convolve import conv1d_poly
from ..ops.precision import dot_precision
from .counts import CubicSim
from .plan import EnginePlan
from .stages import gather_windows, hermite4, prestage_apply

_FRAC = 1 << PHASE_FRAC_BITS

#: 1:1-FIR prototype length above which the FFT overlap-save lowering
#: replaces the banded-matmul convolution (engine/fftstage.py).  The
#: banded conv costs ~2*T flops/sample while the overlap-save path's cost
#: is length-independent, so a crossover exists; this value has not been
#: re-measured on the current accelerator (ROADMAP A6).
FFT_CONV_MIN_TAPS = 6144

#: Crossover for routing the DECIMATE topology through overlap-save.
#: The decimation stage does NOT share FFT_CONV_MIN_TAPS: its matmul
#: lowering is the frames-matmul, not the 1:1 conv, and the default
#: sits beyond the 8191-tap design cap, so the matmul serves every
#: reachable prototype.  The routing machinery stays live (parity-tested
#: at f64) for the day the FFT wins; override with
#: GAR_DECIM_FFT_MIN_TAPS.  Not yet re-measured on the current
#: accelerator (ROADMAP A6; the paired rows are run_all.py decim_long_*).
DECIM_FFT_MIN_TAPS = int(os.environ.get('GAR_DECIM_FFT_MIN_TAPS', 16384))


def _poly_walk_host(plan: EnginePlan, count: int):
    """Host-side exact walk: (div, phase, frac) for outputs 0..count-1."""
    at = plan.at0 + np.arange(count, dtype=np.int64) * plan.step
    hi = at >> PHASE_FRAC_BITS
    div = hi // plan.num_phases
    phase = hi % plan.num_phases
    frac = at & (_FRAC - 1)
    return div.astype(np.int64), phase.astype(np.int64), frac.astype(np.int64)


def _rational_matrix(plan: EnginePlan):
    """Per-period resampling matrix for the exact-rational fast path.

    Output j = m*P + r reads u[m*Ip + delta + (r*s)//L : ... + T2] against
    bank row A[(r*s) % L].  R[r, (r*s)//L + t] = A[phase_r, t] gives
    y[m, r] = dot(frame_m, R[r]) with frame_m = u[m*Ip + delta : + W].
    """
    s = plan.step >> PHASE_FRAC_BITS
    L = plan.num_phases
    g = math.gcd(s, L)
    P = L // g
    Ip = s // g
    T2 = plan.poly_taps
    W = ((P - 1) * s) // L + T2
    R = np.zeros((P, W), dtype=np.float64)
    for r in range(P):
        off = (r * s) // L
        ph = (r * s) % L
        R[r, off:off + T2] = plan.bank_a[ph]
    return R, P, Ip, W


def _poly_apply_general(plan: EnginePlan, xext: jax.Array, count: int,
                        dtype, tile: int = 256, aux=None) -> jax.Array:
    """Banded batched matmul for non-exact-rational ratios.

    The walk is quasi-periodic, so no single per-period matrix exists —
    but within a tile of P outputs the windows span a bounded range, so
    each tile gets its own banded matrix (prestage composed in; see
    _general_matrices) and the whole apply is one batched matmul over
    windows of ``xext`` (the raw input left-padded by T1-1).  This
    replaces a per-output gather + dot.  The matrices depend on (plan,
    count) and are device-cached; they are passed as arguments, not baked
    as constants (a 1-s program's matrices are ~50 MB).
    """
    div, _phase, _frac = _poly_walk_host(plan, count)
    if aux is not None:
        # Matrices prepared host-side by oneshot() and passed as jit
        # ARGUMENTS (a 1-s program's matrices are ~50 MB — baking them
        # as constants would bloat every compile).
        starts_d, M_d = aux
    else:
        starts_np, M_np = _general_matrices(plan, count, tile)
        starts_d = jnp.asarray(starts_np, dtype=jnp.int32)
        M_d = jnp.asarray(M_np, dtype=dtype)
    last_start = int(div[-1]) // plan.factor
    return _banded_tiles_apply(xext, starts_d, M_d, last_start, count, dtype)


def _banded_tiles_apply(u: jax.Array, starts_d: jax.Array, M_d: jax.Array,
                        last_start: int, count: int, dtype) -> jax.Array:
    """Apply per-tile banded matrices: the general/cubic one-shot core.

    Gathers one [W]-wide window per tile at the irregular tile starts and
    runs one batched einsum against the tile matrices.
    """
    w_band = int(M_d.shape[2])
    if u.shape[1] < last_start + w_band:
        u = jnp.pad(u, ((0, 0), (0, last_start + w_band - u.shape[1])))
    frames = gather_windows(u, starts_d, w_band)       # [S, n_tiles, W]
    y = jnp.einsum('stw,tpw->stp', frames, M_d.astype(dtype),
                   preferred_element_type=u.dtype,
                   precision=dot_precision())
    return y.reshape(u.shape[0], -1)[:, :count]


GENERAL_TILE = 256

# LRU cache of host-side banded matrices, keyed on the plan FINGERPRINT
# (not id — see EnginePlan.fingerprint) and bounded in bytes: a service
# hitting many distinct input lengths otherwise grows without limit
# (each (plan, length) entry is tens of MB).
_GENERAL_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_GENERAL_CACHE_BYTES = 0
GENERAL_CACHE_LIMIT = int(os.environ.get(
    'GAR_TPU_MATRIX_CACHE_MB', '512')) * (1 << 20)


def _cache_get(key):
    val = _GENERAL_CACHE.get(key)
    if val is not None:
        _GENERAL_CACHE.move_to_end(key)
    return val


def _cache_put(key, val):
    global _GENERAL_CACHE_BYTES
    _GENERAL_CACHE[key] = val
    _GENERAL_CACHE_BYTES += sum(a.nbytes for a in val)
    while _GENERAL_CACHE_BYTES > GENERAL_CACHE_LIMIT and len(_GENERAL_CACHE) > 1:
        _, old = _GENERAL_CACHE.popitem(last=False)
        _GENERAL_CACHE_BYTES -= sum(a.nbytes for a in old)
    return val


def _general_matrices(plan: EnginePlan, count: int,
                      tile: int = GENERAL_TILE):
    """Host-side banded tile matrices for the general path (cached).

    Returns (starts [n_tiles] int64, M [n_tiles, tile, Wx] float64) in
    the PRESTAGE-COMPOSED x domain: output t*tile + p reads
    ``xext[starts[t] : starts[t] + Wx] @ M[t, p]`` where ``xext`` is the
    raw input left-padded by T1-1 (the prestage ramp).  Composing the 2x
    prestage into the matrices (same algebra as _fused_rational_matrix)
    removes the materialized upsampled stream u — the device reads x
    once instead of writing+reading a 2x intermediate.

    The composition runs as two class-einsums: the u->x change of basis
    depends only on the tile's u-start parity, so tiles split into F
    classes sharing one [W_u, Wx] prestage matrix each.
    """
    key = (plan.fingerprint, count, tile)
    cached = _cache_get(key)
    if cached is not None:
        return cached
    div, phase, frac = _poly_walk_host(plan, count)
    x = (frac.astype(np.float64) / _FRAC)[:, None]
    K_host = (plan.bank_a[phase] + x * (plan.bank_b[phase] +
              x * (plan.bank_c[phase] + x * plan.bank_d[phase])))
    t2 = plan.poly_taps
    padded = -(-count // tile) * tile
    div_p = np.pad(div, (0, padded - count), mode='edge')
    K_p = np.pad(K_host, ((0, padded - count), (0, 0)))
    div_r = div_p.reshape(-1, tile)                # [n_tiles, P]
    starts_u = div_r[:, 0].copy()                  # [n_tiles] u-domain
    offs = div_r - starts_u[:, None]               # >= 0, monotone
    w_u = int(offs[:, -1].max()) + t2
    n_tiles = div_r.shape[0]
    M_u = np.zeros((n_tiles, tile, w_u), dtype=np.float64)
    rows = np.repeat(np.arange(n_tiles), tile)
    cols = np.tile(np.arange(tile), n_tiles)
    for t in range(t2):
        M_u[rows, cols, offs.ravel() + t] = K_p[:, t]

    # Compose the prestage: u[m] = sum_tau pre[m % F, tau] * xext[m//F + tau]
    # => per u-start class c = start_u % F, the change of basis is
    # P_c[m, (m+c)//F + tau] = pre[(m+c) % F, tau], shared by all tiles
    # of that class; starts_x = starts_u // F.
    F, T1 = plan.factor, plan.pre_taps
    pre = plan.pre_coeffs
    w_x = (w_u - 1 + F - 1) // F + T1
    starts_x = starts_u // F
    M = np.empty((n_tiles, tile, w_x), dtype=np.float64)
    for c in range(F):
        sel = np.nonzero(starts_u % F == c)[0]
        if not len(sel):
            continue
        P_c = np.zeros((w_u, w_x), dtype=np.float64)
        for m in range(w_u):
            base = (m + c) // F
            P_c[m, base:base + T1] = pre[(m + c) % F]
        M[sel] = np.einsum('tpu,uw->tpw', M_u[sel], P_c)
    return _cache_put(key, (starts_x, M))


def _cubic_matrices(plan: EnginePlan, count: int,
                    tile: int = GENERAL_TILE):
    """Banded tile matrices for the cubic (QUICK) walk (cached).

    Same structure as _general_matrices with 4-tap rows: output j reads
    histbuf[i_j .. i_j+3] (histbuf = x left-padded by 3) against the
    Catmull-Rom basis evaluated at frac_j.  The basis weights are
    extracted numerically by pushing unit taps through the hermite
    formula (stages.hermite4), so the matmul is bit-faithful to it.
    """
    key = ('cubic', plan.fingerprint, count, tile)
    cached = _cache_get(key)
    if cached is not None:
        return cached
    at = np.arange(count, dtype=np.int64) * plan.cubic_step
    i = (at >> CubicSim.FRAC_BITS).astype(np.int64)
    fr = (at & ((1 << CubicSim.FRAC_BITS) - 1)).astype(np.float64) \
        / (1 << CubicSim.FRAC_BITS)
    # Basis: y = a x^3 + b x^2 + c x + s0 with a, b, c linear in taps.
    K = np.empty((count, 4), dtype=np.float64)
    for k in range(4):
        sm1, s0, s1, s2 = (1.0 if k == 0 else 0.0), (1.0 if k == 1 else 0.0), \
            (1.0 if k == 2 else 0.0), (1.0 if k == 3 else 0.0)
        b = 0.5 * (s1 + sm1) - s0
        a = (1.0 / 6.0) * (s2 - s1 + sm1 - s0 - 4.0 * b)
        c = s1 - s0 - a - b
        K[:, k] = ((a * fr + b) * fr + c) * fr + s0
    padded = -(-count // tile) * tile
    div_p = np.pad(i, (0, padded - count), mode='edge')
    K_p = np.pad(K, ((0, padded - count), (0, 0)))
    div_r = div_p.reshape(-1, tile)
    starts = div_r[:, 0].copy()
    offs = div_r - starts[:, None]
    w_band = int(offs[:, -1].max()) + 4
    n_tiles = div_r.shape[0]
    M = np.zeros((n_tiles, tile, w_band), dtype=np.float64)
    rows = np.repeat(np.arange(n_tiles), tile)
    cols = np.tile(np.arange(tile), n_tiles)
    for t in range(4):
        M[rows, cols, offs.ravel() + t] = K_p[:, t]
    return _cache_put(key, (starts, M))


_DECIM_CACHE: dict = {}
DECIM_PERIOD = 256  # outputs per frame for the decimation frames-matmul


def _decim_matrix(plan: EnginePlan, period: int = DECIM_PERIOD):
    """Banded per-period matrix for integer decimation.

    Output j reads x~[j*M : j*M + T]; grouping P outputs per frame gives
    frames of width W = (P-1)*M + T with stride P*M and a constant
    [P, W] matrix R[r, r*M : r*M + T] = coeffs — one matmul per frame
    instead of a long strided convolution.
    """
    key = (plan.fingerprint, period)
    if key in _DECIM_CACHE:
        return _DECIM_CACHE[key]
    m, t = plan.factor, plan.decim_taps
    p = period
    w = (p - 1) * m + t
    r = np.zeros((p, w), dtype=np.float64)
    for row in range(p):
        r[row, row * m:row * m + t] = plan.decim_coeffs
    _DECIM_CACHE[key] = (r, p, p * m)
    return _DECIM_CACHE[key]


def _decim_apply_matmul(plan: EnginePlan, xs: jax.Array, count: int,
                        dtype) -> jax.Array:
    """Apply integer decimation via frames + one matmul."""
    R, P, Ipx = _decim_matrix(plan)
    wx = R.shape[1]
    n_frames = -(-count // P)
    need = (n_frames - 1) * Ipx + wx
    if xs.shape[1] < need:
        xs = jnp.pad(xs, ((0, 0), (0, need - xs.shape[1])))
    starts = jnp.asarray(np.arange(n_frames, dtype=np.int64) * Ipx,
                         dtype=jnp.int32)
    frames = gather_windows(xs, starts, wx)
    Rt = jnp.asarray(R.T, dtype=dtype)
    y = jnp.einsum('sfw,wp->sfp', frames, Rt,
                   preferred_element_type=xs.dtype,
                   precision=dot_precision())
    return y.reshape(xs.shape[0], n_frames * P)[:, :count]


def superframe(r: np.ndarray, ipx: int, *, max_overlap: float = 1.5,
               max_bytes: int = 64 << 20, kf_cap: int | None = None):
    """Group kf periods per frame: block-Toeplitz [kf*P, W + (kf-1)*I].

    A banded operator with W >> I makes the dense-frames lowering read
    each input ~W/I times (the 48k->8k fused pipeline composite has
    W/I = 311).  Framing kf periods together amortizes the overlap: frames advance kf*I and read
    W + (kf-1)*I, so the read amplification drops to 1 + (W-I)/(kf*I)
    (<= 1 + max_overlap by choice of kf), at the cost of a
    [kf*P, W+(kf-1)*I] matrix whose zeros add ~max_overlap extra MACs —
    matmul throughput is the cheap resource here, memory bandwidth the
    scarce one.  Returns (r_super, ipx_super); identity when already compact
    (the 1.5 default leaves moderately overlapped shapes like CD->DAT,
    W/I = 1.7, unchanged).

    ``kf_cap`` bounds the super-period in input samples (streaming
    engines cap it near their block size to keep latency).
    """
    p, w = r.shape
    if ipx <= 0 or w - ipx <= max_overlap * ipx:
        return r, ipx
    kf = -(-(w - ipx) // max(int(max_overlap * ipx), 1))
    if kf_cap is not None:
        kf = min(kf, max(kf_cap, 1))
    while kf > 1 and (w + (kf - 1) * ipx) * (kf * p) * 4 > max_bytes:
        kf -= 1
    if kf <= 1:
        return r, ipx
    ws = w + (kf - 1) * ipx
    rs = np.zeros((kf * p, ws), dtype=r.dtype)
    for f in range(kf):
        rs[f * p:(f + 1) * p, f * ipx:f * ipx + w] = r
    return rs, kf * ipx


_FUSED_CACHE: dict = {}


def _fused_rational_matrix(plan: EnginePlan):
    """Compose prestage + polyphase into one per-period matrix over x.

    For exact-rational ratios both stages are periodically time-varying
    linear operators; their composition is again periodic.  With the
    engine's alignment (prestage zero-carry + at0 = (T1-1)*F*L<<16) the
    m-th frame of the composed operator starts exactly at x[m * Ipx]:

      output j = m*P2 + r  reads u[delta + m*Ipu + (r*s)//L : +T2]
      u[i*F + p][x] = sum_tau pre[p, tau] * x[i + tau - (T1-1)]
      => x-coefficient index rel. frame start = (div+t)//F + tau - (T1-1)
         - m*Ipx, which is >= 0 with min 0 (delta//F == T1-1).

    When the plan carries the strict-antialias prefilter, the 1:1 lowpass
    is composed into the matrix too (pipeline/fused.py compose), giving
    ``lam`` > 0: period m then reads (0^lam ++ x)[m*Ipx : m*Ipx + Wx].
    The aa tail thus extends naturally into the flush padding (no hard
    truncation at the input length; same semantics as the composite
    pipeline operator and the numpy oracle).

    Returns (R [P2, Wx], P2 outputs/period, Ipx input samples/period,
    lam left zero-context).  Computed once per plan in float64 and cached.
    """
    key = plan.fingerprint
    if key in _FUSED_CACHE:
        return _FUSED_CACHE[key]
    s = plan.step >> PHASE_FRAC_BITS
    L = plan.num_phases
    F = plan.factor
    T1 = plan.pre_taps
    T2 = plan.poly_taps
    g = math.gcd(s, L)
    P = L // g
    Ip = s // g                      # u samples per P outputs
    k = F // math.gcd(Ip, F)         # periods to make the u stride F-aligned
    P2 = k * P
    Ipu = k * Ip
    Ipx = Ipu // F                   # input samples per frame
    delta = plan.lengths.core_delta()
    assert delta // F == T1 - 1 and delta % F == 0

    pre = plan.pre_coeffs            # [F, T1] float64, tap-reversed
    A = plan.bank_a                  # [L, T2] float64, tap-reversed
    wx = (delta + Ipu - 1 + T2 - 1) // F + (T1 - 1) - (T1 - 1) + 1
    R = np.zeros((P2, wx), dtype=np.float64)
    max_j = 0
    for r in range(P2):
        o_r = delta + (r * s) // L   # u index of window start (m=0 frame)
        ph = (r * s) % L
        for t in range(T2):
            m_u = o_r + t
            i = m_u // F
            p = m_u % F
            a = A[ph, t]
            if a == 0.0:
                continue
            # u[m_u] = sum_tau pre[p, tau] * x[i + tau - (T1-1)]
            j0 = i - (T1 - 1)
            R[r, j0:j0 + T1] += a * pre[p]
            max_j = max(max_j, j0 + T1 - 1)
    R = R[:, :max_j + 1]
    lam = 0
    if plan.aa_taps:
        from ..pipeline.fused import BandedOp, compose
        d = (plan.aa_taps - 1) // 2
        aa = BandedOp(P=1, I=1, W=plan.aa_taps,
                      R=np.asarray(plan.aa_coeffs,
                                   dtype=np.float64)[None, :],
                      lam=d, lengths=())
        core = BandedOp(P=P2, I=Ipx, W=R.shape[1], R=R, lam=0, lengths=())
        comp = compose(aa, core)
        R, P2, Ipx, lam = comp.R, comp.P, comp.I, comp.lam
    _FUSED_CACHE[key] = (R, P2, Ipx, lam)
    return _FUSED_CACHE[key]


def _poly_apply_rational_fused(plan: EnginePlan, x: jax.Array, count: int,
                               dtype) -> jax.Array:
    """One matmul for the whole two-stage cascade (fast path).

    ``x`` is the raw input: this function applies all padding itself
    (``lam`` virtual zeros on the left when the strict-antialias prefilter
    is composed into the matrix, coverage zeros on the right).  Halves memory
    traffic vs. the unfused path: no intermediate upsampled stream or
    u-frames are materialized.
    """
    R, P2, Ipx, lam = _fused_rational_matrix(plan)
    # Bound the frames-overlap read amplification (strict-antialias plans
    # fold a ~1k-tap prefilter into R, pushing W/I into the hundreds).
    R, Ipx = superframe(R, Ipx)
    P2 = R.shape[0]
    wx = R.shape[1]
    n_frames = -(-count // P2)
    if lam:
        x = jnp.pad(x, ((0, 0), (lam, 0)))

    need = (n_frames - 1) * Ipx + wx
    if x.shape[1] < need:
        x = jnp.pad(x, ((0, 0), (0, need - x.shape[1])))
    starts = jnp.asarray(np.arange(n_frames, dtype=np.int64) * Ipx,
                         dtype=jnp.int32)
    frames = gather_windows(x, starts, wx)                  # [S, F, Wx]
    Rt = jnp.asarray(R.T, dtype=dtype)                      # [Wx, P2]
    y = jnp.einsum('sfw,wp->sfp', frames, Rt,
                   preferred_element_type=x.dtype,
                          precision=dot_precision())
    return y.reshape(x.shape[0], n_frames * P2)[:, :count]


def _poly_apply_rational(plan: EnginePlan, u: jax.Array, count: int,
                         dtype) -> jax.Array:
    """Frames-matmul fast path: one [S*F, W] x [W, P] matmul."""
    R, P, Ip, W = _rational_matrix(plan)
    delta = plan.lengths.core_delta()
    n_frames = -(-count // P)
    need = delta + (n_frames - 1) * Ip + W
    if u.shape[1] < need:
        u = jnp.pad(u, ((0, 0), (0, need - u.shape[1])))
    starts = jnp.asarray(delta + np.arange(n_frames, dtype=np.int64) * Ip,
                         dtype=jnp.int32)
    frames = gather_windows(u, starts, W)                     # [S, F, W]
    Rt = jnp.asarray(R.T, dtype=dtype)                        # [W, P]
    y = jnp.einsum('sfw,wp->sfp', frames, Rt,
                   preferred_element_type=u.dtype,
                          precision=dot_precision())
    return y.reshape(u.shape[0], n_frames * P)[:, :count]


def oneshot(plan: EnginePlan, x: jax.Array, dtype=None) -> jax.Array:
    """Resample x [S, n] -> y [S, canonical(n)] in one compiled program.

    Equivalent to the reference's Process+Flush one-shot stream
    (convenience.go:204-229).  The program is jit-compiled and cached per
    (plan, batch, length, dtype); all length bookkeeping is trace-time.
    """
    if x.ndim != 2:
        raise ValueError(f"oneshot expects [streams, samples], got {x.shape}")
    dtype = jnp.dtype(dtype or x.dtype)
    aux = _oneshot_aux(plan, int(np.shape(x)[1]), dtype)
    return _oneshot_jit(plan, jnp.asarray(x), dtype.name, *aux)


def _oneshot_aux(plan: EnginePlan, n: int, dtype):
    """Host-prepared device arguments for the jitted program.

    The general (non-exact-rational) path's banded tile matrices are
    tens of MB per (plan, length); passing them as arguments keeps them
    out of the compiled program.
    """
    if plan.lengths.canonical(n) <= 0 or n <= 0:
        return ()
    if plan.kind == 'two_stage' and not plan.is_rational_exact:
        starts, M = _general_matrices(plan, plan.lengths.canonical(n))
        return (jnp.asarray(starts, dtype=jnp.int32),
                jnp.asarray(M, dtype=dtype))
    if plan.kind == 'cubic':
        starts, M = _cubic_matrices(plan, plan.lengths.canonical(n))
        return (jnp.asarray(starts, dtype=jnp.int32),
                jnp.asarray(M, dtype=dtype))
    return ()


@partial(jax.jit, static_argnums=(0, 2))
def _oneshot_jit(plan: EnginePlan, x: jax.Array, dtype_name: str,
                 *aux) -> jax.Array:
    dtype = jnp.dtype(dtype_name)
    x = x.astype(dtype)
    n = x.shape[1]
    lm = plan.lengths
    canonical = lm.canonical(n)
    if canonical <= 0 or n == 0:
        return jnp.zeros((x.shape[0], max(canonical, 0)), dtype=dtype)
    z = lm.flush_pad(n)

    if plan.kind == 'cubic':
        if aux:
            starts_d, M_d = aux
        else:
            starts_np, M_np = _cubic_matrices(plan, canonical)
            starts_d = jnp.asarray(starts_np, dtype=jnp.int32)
            M_d = jnp.asarray(M_np, dtype=dtype)
        w_band = int(M_d.shape[2])
        at_last = (canonical - 1) * plan.cubic_step
        i_last = int(at_last >> CubicSim.FRAC_BITS)
        histbuf = jnp.pad(x, ((0, 0), (3, max(0, i_last + w_band + 1
                                              - (n + 3)))))
        # Tile starts are <= the last window index; i_last bounds them.
        return _banded_tiles_apply(histbuf, starts_d, M_d, i_last,
                                   canonical, dtype)

    if plan.kind == 'dft_up':
        t1, f = plan.pre_taps, plan.factor
        if f == 1:
            return x  # unity ratio: pass-through (dft_stage.go:57-59)
        xext = jnp.pad(x, ((0, 0), (t1 - 1, z)))
        coeffs = jnp.asarray(plan.pre_coeffs, dtype=dtype)
        u = prestage_apply(coeffs, xext, f)
        drop = lm.drop_prefix()
        return u[:, drop:drop + canonical]

    if plan.kind == 'decimate':
        t, m = plan.decim_taps, plan.factor
        # windows at absolute positions t-1 + j*M over (0^{t-1} x 0^z ...)
        need = (t - 1) + (canonical - 1) * m + t
        pad_right = max(z, need - (t - 1 + n))
        xext = jnp.pad(x, ((0, 0), (t - 1, pad_right)))
        if t >= DECIM_FFT_MIN_TAPS:
            # Overlap-save routing for prototypes past the decimate
            # crossover (see DECIM_FFT_MIN_TAPS).
            from .fftstage import _fft_decimate
            return _fft_decimate(plan, xext[:, t - 1:], canonical)
        return _decim_apply_matmul(plan, xext[:, t - 1:], canonical, dtype)

    # two_stage
    if plan.is_rational_exact:
        # Fused path: both stages (and the strict-antialias prefilter,
        # when present) composed into one banded matmul over the raw x;
        # all padding happens inside.
        return _poly_apply_rational_fused(plan, x, canonical, dtype)
    if plan.aa_taps:
        # strict-antialias prefilter: delay-compensated 'same' lowpass at
        # the input rate (EnginePlan.aa_coeffs), extended over the flush
        # padding (natural tail — same semantics as the fused/composed
        # paths and the numpy oracle): filter (x ++ 0^z) then continue
        # with no further right padding.  Prototypes past the measured
        # matmul crossover route through FFT overlap-save (the banded
        # conv's cost grows linearly with taps; the FFT's does not).
        d = (plan.aa_taps - 1) // 2
        xext = jnp.pad(x, ((0, 0), (d, d + z)))
        if plan.aa_taps >= FFT_CONV_MIN_TAPS:
            from .fftstage import fft_correlate
            x = fft_correlate(xext, np.asarray(plan.aa_coeffs,
                                               dtype=np.float64),
                              n + z).astype(dtype)
        else:
            h = jnp.asarray(plan.aa_coeffs, dtype=dtype)
            x = conv1d_poly(xext, h[None, :], stride=1)[:, 0, :]
        z = 0
    t1 = plan.pre_taps
    # Prestage is composed into the banded tile matrices (x domain); the
    # device never materializes the 2x intermediate stream.
    xext = jnp.pad(x, ((0, 0), (t1 - 1, z)))
    return _poly_apply_general(plan, xext, canonical, dtype,
                               aux=aux if aux else None)
