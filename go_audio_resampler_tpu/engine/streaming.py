"""Streaming engine: stateful Process/Flush over fixed-size blocks.

Accelerator-side replacement for the reference's streaming engine
(engine/resampler.go:182-340).  The device side is a single jitted
``step`` function per topology — pure ``(state, block) -> (state', y,
n_valid)`` with static shapes — and the host wrapper feeds fixed
micro-blocks from an input accumulator, so arbitrary chunk sizes stream
through one compiled program.  Chunking invariance holds by construction:
the emitted sample stream depends only on the concatenated input
(SURVEY.md section 4.4 contract).

Flush follows the reference's orchestration (resampler.go:275-322) via the
length model: the engine feeds the exact zero padding that drains every
stage, then trims the total stream to the canonical output count.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..ops.precision import dot_precision
from ..pipeline.buffer import SampleFIFO
from .plan import EnginePlan
from . import stages
from .stages import (CubicState, DecimState, PolyState, PrestageState, I32)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# Module-level jitted step functions: constants are traced arguments and the
# per-topology configuration is static, so the XLA cache is shared across
# EngineCore instances with the same plan/shapes.

@partial(jax.jit, static_argnames=('cubic_step', 'cap'),
         donate_argnames=('state',))
def _step_cubic(state, x, cubic_step, cap):
    st, y, valid, n = stages.cubic_process(state, x, cubic_step, cap)
    return st, y, n


@partial(jax.jit, static_argnames=('precision',),
         donate_argnames=('carry',))
def _step_fir(coeffs, carry, x, precision='auto'):
    return stages.fir_process(coeffs, carry, x, precision)


def _fir_fft_step(coeffs_np, carry, x):
    """Causal streaming FIR via FFT overlap-save (long prototypes).

    Same contract as stages.fir_process; used when the prefilter length
    crosses oneshot.FFT_CONV_MIN_TAPS (the banded conv's cost grows
    linearly with taps, the overlap-save path's does not)."""
    from .fftstage import fft_correlate
    xext = jnp.concatenate([carry.astype(x.dtype), x], axis=1)
    y = fft_correlate(xext, coeffs_np, x.shape[1])
    return xext[:, x.shape[1]:], y


@partial(jax.jit, static_argnames=('factor', 'precision'),
         donate_argnames=('state',))
def _step_dft_up(coeffs, state, x, factor, precision='auto'):
    st, u = stages.prestage_process(coeffs, state, x, factor, precision)
    return st, u, I32(u.shape[1])


@partial(jax.jit, static_argnames=('factor', 'precision'),
         donate_argnames=('state',))
def _step_decim(coeffs, state, x, factor, precision='auto'):
    st, y, valid, n = stages.decim_process(coeffs, state, x, factor,
                                           precision)
    return st, y, n


def _fused_banded_step(r_t, carry, x, ipx, wx, p2, precision='auto'):
    """Shared pure body of the fused banded-matmul streaming steps.

    Gathers period-aligned frames from [carry ++ block] and applies the
    per-period matrix in one matmul; with the block a multiple of the
    input period ``ipx``, every step emits exactly (B/ipx)*p2 samples.
    ``precision`` pins the matmul tier.
    """
    b = x.shape[1]
    n_frames = b // ipx
    data = jnp.concatenate([carry.astype(x.dtype), x], axis=1)
    y = _banded_frames_apply(data, r_t, ipx, wx, p2, n_frames, precision)
    return data[:, b:], y, I32(n_frames * p2)


def _banded_frames_apply(data, r_t, ipx, wx, p2, n_frames,
                         precision: str = 'auto'):
    """Windows at j*ipx of width wx times r_t [wx, p2] -> [S, F*p2].

    ``precision`` is the per-engine matmul tier pin ('auto' = the
    process-global GAR_TPU_MATMUL_PRECISION, read at trace time).
    """
    s = data.shape[0]
    starts = lax.iota(jnp.int32, n_frames) * I32(ipx)
    frames = stages.gather_windows(data, starts, wx)
    y = jnp.einsum('sfw,wp->sfp', frames, r_t.astype(data.dtype),
                   preferred_element_type=data.dtype,
                   precision=dot_precision(precision))
    return y.reshape(s, n_frames * p2)


def _fft_decim_step(coeffs_np, factor: int, carry, x):
    """Streaming decimation via FFT overlap-save (long prototypes).

    Same carry discipline and canonical grid as the banded decim step
    (window j reads (0^C ++ stream)[j*M : j*M+T] with the zeros realized
    as the zeros-initialized carry), but the correlation runs through
    fftstage.fft_correlate — T-independent per-sample cost, which wins
    past oneshot.DECIM_FFT_MIN_TAPS (see fftstage.py's crossover
    rationale).  Output counts stay static: (B/M) samples per block.
    """
    from .fftstage import fft_correlate
    b = x.shape[1]
    n_frames = b // factor
    data = jnp.concatenate([carry.astype(x.dtype), x], axis=1)
    f = fft_correlate(data, coeffs_np, (n_frames - 1) * factor + 1)
    y = f[:, ::factor][:, :n_frames]
    return data[:, b:], y, I32(n_frames)


@partial(jax.jit, static_argnames=('ipx', 'wx', 'p2', 'precision'),
         donate_argnames=('carry',))
def _step_decim_fused(r_t, carry, x, ipx, wx, p2, precision='auto'):
    """Fused streaming decimation: banded frames-matmul per block.

    carry holds the last T-1 input samples (zeros-init); every step emits
    exactly (B/Ipx)*P outputs on the canonical grid
    (window j = (0^{T-1} ++ stream)[j*M : j*M+T]), so no transient drop is
    needed.  Replaces the long strided convolution.
    """
    return _fused_banded_step(r_t, carry, x, ipx, wx, p2, precision)


@partial(jax.jit, static_argnames=('factor', 'num_phases', 'taps', 'step_hi',
                                   'step_lo', 'cap', 'precision'),
         donate_argnames=('state',))
def _step_two_stage(pre_coeffs, banks, state, x, factor, num_phases, taps,
                    step_hi, step_lo, cap, precision='auto'):
    pre_state, poly_state = state
    pre_state, u = stages.prestage_process(pre_coeffs, pre_state, x, factor,
                                           precision)
    poly_state, y, valid, n = stages.poly_process(
        banks, poly_state, u, num_phases, taps, step_hi, step_lo, cap,
        precision)
    return (pre_state, poly_state), y, n


@partial(jax.jit, static_argnames=('ipx', 'wx', 'p2', 'precision'),
         donate_argnames=('carry',))
def _step_rational_fused(r_t, carry, x, ipx, wx, p2, precision='auto'):
    """Fused streaming step for exact-rational two-stage plans.

    The whole cascade is one periodic banded operator (see
    oneshot._fused_rational_matrix).  With the block size a multiple of the
    input period Ipx, every step emits exactly (B/Ipx)*P2 samples: frames
    are gathered from [carry ++ block] at static period-aligned starts and
    multiplied in one matmul — the streaming analog of the one-shot fused
    path.  The leading (C/Ipx)*P2 outputs of the stream are the zero-carry
    convolution ramp; the wrapper drops them (same mechanism as the
    single-stage DFT topology).
    """
    return _fused_banded_step(r_t, carry, x, ipx, wx, p2, precision)


def pipelined_stream(eng, chunks, out: str, granule: int):
    """Shared pipelined-stream protocol (EngineCore.stream and the
    variable-rate twin both delegate here — one copy of the carve /
    one-chunk-lag / remainder logic).

    ``eng`` provides ``batch``/``dtype``/``process_device``/``process``/
    ``flush_device``.  Input chunks of any widths are carved into
    ``granule`` multiples; the download of chunk k is deferred until
    chunk k+1 has been dispatched (JAX dispatch is async), so transfer
    rides under compute.  A sub-granule remainder goes through the host
    ``process`` path — anything it emits (possible when prior host input
    was already buffered, or when the granule exceeds the host block) is
    yielded in order, and ``flush_device`` folds the rest into the tail.
    """
    if out not in ('host', 'device'):
        raise ValueError(f"out must be 'host' or 'device', got {out!r}")

    def _norm(x) -> np.ndarray:
        x = np.asarray(x, dtype=eng.dtype)
        if x.ndim == 1:
            x = (np.broadcast_to(x, (eng.batch, x.shape[0]))
                 if eng.batch > 1 else x[None, :])
        return x

    def _pop(pend):
        return np.asarray(pend) if out == 'host' else pend

    pend = None                              # dispatched, not downloaded
    buf = np.zeros((eng.batch, 0), eng.dtype)
    for x in chunks:
        buf = np.concatenate([buf, _norm(x)], axis=1)
        n = (buf.shape[1] // granule) * granule
        if not n:
            continue
        y = eng.process_device(jnp.asarray(buf[:, :n]))
        buf = buf[:, n:]
        if pend is not None and pend.shape[1]:
            yield _pop(pend)                 # overlaps y's device work
        pend = y
    if buf.shape[1]:
        got = eng.process(buf)
        if got.shape[1]:
            if pend is not None and pend.shape[1]:
                yield _pop(pend)
            pend = jnp.asarray(got) if out == 'device' else got
    tail = eng.flush_device()
    if pend is not None and pend.shape[1]:
        yield _pop(pend)
    if tail.shape[1]:
        yield _pop(tail)


class EngineCore:
    """Stateful streaming resampler over a batch of independent streams.

    The reference processes channels with one goroutine each
    (constant.go:224-241); here all ``batch`` streams ride the leading
    array axis through one device program (SURVEY.md section 2).

    Parameters:
      plan:   built engine plan (filters + topology)
      batch:  number of parallel streams S
      block:  internal micro-block size B (input samples per device step)
      dtype:  compute dtype (float32 for serving; float64 for parity
              runs)
      precision: matmul tier ('auto' | 'highest' | 'high' | 'default',
              see ops/precision.py)
    """

    #: blocks per fused multi-block launch (lax.scan); amortizes the
    #: per-call dispatch latency for small-block streaming
    SCAN_BLOCKS = 8

    def __init__(self, plan: EnginePlan, batch: int = 1, block: int = 2048,
                 dtype=jnp.float32, precision: str = 'auto'):
        from ..ops.precision import PRECISION_MODES
        if precision not in PRECISION_MODES:
            raise ValueError(
                f"precision must be one of {PRECISION_MODES}, "
                f"got {precision!r}")
        self.plan = plan
        self.batch = batch
        self.block = block
        #: Per-engine matmul tier ('auto' = the process-global
        #: GAR_TPU_MATMUL_PRECISION): two engines in one process can
        #: serve different tiers (exact-f32 quality vs the 1-pass bf16
        #: ingest tier) without cache clears — the tier is part of each
        #: step's static jit key.  Scope: every matmul/conv site — the
        #: fused banded steps (rational/decimate/banded composite), the
        #: dft_up prestage conv, the general two-stage walk (prestage +
        #: poly emit), and the aa prefilter.  The cubic stage is pure
        #: elementwise work (no matmul), so the tier is a no-op
        #: there; the FFT overlap-save paths likewise have no matmul.
        self.precision = precision
        self.dtype = jnp.dtype(dtype)
        self._build_constants()
        self._step = self._make_step()
        self._scan_step = None   # built lazily on first multi-block call
        self.reset()

    # -- construction ------------------------------------------------------

    def _build_constants(self):
        p = self.plan
        if p.kind in ('dft_up', 'two_stage'):
            self.pre_coeffs = jnp.asarray(p.pre_coeffs, dtype=self.dtype)
        # Exact-rational plans fold the strict-antialias prefilter into the
        # fused banded matrix (oneshot._fused_rational_matrix); the host
        # FIFO machinery below is needed only for the non-exact walk.
        self._has_aa = (p.kind == 'two_stage' and p.aa_taps > 0
                        and not p.is_rational_exact)
        if self._has_aa:
            from .oneshot import FFT_CONV_MIN_TAPS
            self._aa_coeffs = jnp.asarray(p.aa_coeffs, dtype=self.dtype)
            self._aa_delay = (p.aa_taps - 1) // 2
            if p.aa_taps >= FFT_CONV_MIN_TAPS:
                self._fir_fn = jax.jit(partial(
                    _fir_fft_step, np.asarray(p.aa_coeffs,
                                              dtype=np.float64)))
            else:
                self._fir_fn = partial(_step_fir, self._aa_coeffs,
                                       precision=self.precision)
        self._drop_override = None
        self.rational_fused = False
        if p.kind == 'two_stage':
            if p.is_rational_exact:
                # Fused streaming: the whole cascade (incl. the aa
                # prefilter when present) as one periodic banded matmul
                # (see _step_rational_fused).  The zero carry C >= Wx-Ipx
                # with C == lam (mod Ipx) places the canonical grid
                # (C-lam)/Ipx periods into the core stream; the wrapper
                # drops that ramp.
                from .oneshot import _fused_rational_matrix, superframe
                r, p2, ipx, lam = _fused_rational_matrix(p)
                # Bound the per-block frames-overlap read amplification;
                # the super-period is capped near the requested block so
                # streaming latency stays at the caller's scale.
                r, ipx = superframe(r, ipx,
                                    kf_cap=max(1, self.block // ipx))
                p2 = r.shape[0]
                self.rational_fused = True
                self._rational_rt = jnp.asarray(r.T, dtype=self.dtype)
                self._rational_p2 = p2
                self._rational_ipx = ipx
                self._rational_wx = r.shape[1]
                self.block = _ceil_div(self.block, ipx) * ipx
                self._rational_carry = lam + _ceil_div(
                    max(self._rational_wx - ipx - lam, 0), ipx) * ipx
                self._drop_override = \
                    ((self._rational_carry - lam) // ipx) * p2
            else:
                self.banks = tuple(jnp.asarray(b, dtype=self.dtype) for b in
                                   (p.bank_a, p.bank_b, p.bank_c, p.bank_d))
                m = self.block * p.factor
                self.poly_cap = _ceil_div(m * p.num_phases * 65536, p.step) + 1
                # int32 safety for the two-limb walk (stages.walk16):
                # j * step_lo must stay below 2^31, so cap < 2^15.
                while self.poly_cap > 32767 and self.block > 1:
                    self.block //= 2
                    m = self.block * p.factor
                    self.poly_cap = _ceil_div(
                        m * p.num_phases * 65536, p.step) + 1
                if self.poly_cap > 32767:
                    raise ValueError(
                        f"polyphase walk cap {self.poly_cap} exceeds the "
                        f"int32 bound even at block=1 (ratio {p.ratio}); "
                        "ratio out of supported range")
                # keep = residual history bound (see stages.py poly_process)
                step_in = _ceil_div(p.step, p.num_phases * 65536)
                self.poly_keep = p.poly_taps + step_in + 2
                self.hist_size = self.poly_keep + m + p.lengths.core_delta()
        if p.kind == 'decimate':
            from .oneshot import DECIM_FFT_MIN_TAPS, _decim_matrix, superframe
            self._decim_fft = p.decim_taps >= DECIM_FFT_MIN_TAPS
            if self._decim_fft:
                # Long prototype: banded matmul loses to overlap-save
                # (fftstage.py crossover); stream through _fft_decim_step.
                # Grid parameters: one output per factor inputs.
                self._decim_coeffs_np = np.asarray(p.decim_coeffs,
                                                   dtype=np.float64)
                self._decim_ipx = p.factor
                self._decim_p2 = 1
                self._decim_wx = p.decim_taps
                self.block = _ceil_div(self.block, p.factor) * p.factor
            else:
                r, p2, ipx = _decim_matrix(p)
                r, ipx = superframe(r, ipx, kf_cap=max(1, self.block // ipx))
                p2 = r.shape[0]
                self._decim_rt = jnp.asarray(r.T, dtype=self.dtype)
                self._decim_p2 = p2
                self._decim_ipx = ipx
                self._decim_wx = r.shape[1]
                self.block = _ceil_div(self.block, ipx) * ipx
            # Canonical window j reads x[j*M : j*M+T] (no zero samples);
            # a zero carry of C = round_up(T-1, M) shifts the local grid by
            # C/M ramp outputs which the wrapper drops.
            self._decim_carry = _ceil_div(p.decim_taps - 1, p.factor) \
                * p.factor
            self._drop_override = self._decim_carry // p.factor
        if p.kind == 'banded':
            # Composite fused-pipeline operator (pipeline/fused.py):
            # canonical period m reads (0^lam ++ x)[m*I : m*I + W].  The
            # zero carry C >= W - I with C == lam (mod I) places the
            # canonical grid (C - lam)/I periods into the core stream;
            # the wrapper drops that ramp.  When the composite has an
            # aperiodic head (chains with a mid-stream aa prefilter), the
            # wrapper overwrites the first n_head canonical outputs with
            # the exact host-computed head rows (_emit).
            from .oneshot import superframe
            op = p.op
            r, ipx = superframe(op.R, op.I,
                                kf_cap=max(1, self.block // op.I))
            p2, wx, lam = r.shape[0], r.shape[1], op.lam
            self._banded_rt = jnp.asarray(r.T, dtype=self.dtype)
            self._banded_p2 = p2
            self._banded_ipx = ipx
            self._banded_wx = wx
            self._banded_head = op.head
            self._banded_lam = lam
            self.block = _ceil_div(self.block, ipx) * ipx
            self._banded_carry = lam + _ceil_div(
                max(wx - ipx - lam, 0), ipx) * ipx
            self._drop_override = ((self._banded_carry - lam) // ipx) * p2
        if p.kind == 'cubic':
            self.cubic_cap = _ceil_div(self.block << 32, p.cubic_step) + 1
            # int32 safety for the two-limb walk32 (stages.py:56-73):
            # j * s_f0 / j * s_f1 must stay below 2^31, so cap < 2^15 —
            # the same bound as the polyphase walk16 clamp above.  Without
            # this, upsampling ratios >~16 silently wrap the sample index.
            while self.cubic_cap > 32767 and self.block > 1:
                self.block //= 2
                self.cubic_cap = _ceil_div(self.block << 32, p.cubic_step) + 1

    def _init_state(self):
        p, s, d = self.plan, self.batch, self.dtype
        if p.kind == 'cubic':
            return CubicState(carry=jnp.zeros((s, 3), d),
                              at_int=I32(0), at_f1=I32(0), at_f0=I32(0))
        if p.kind == 'dft_up':
            return PrestageState(
                carry=jnp.zeros((s, max(p.pre_taps - 1, 0)), d))
        if p.kind == 'decimate':
            return jnp.zeros((s, self._decim_carry), d)
        if p.kind == 'banded':
            return jnp.zeros((s, self._banded_carry), d)
        # two_stage
        if self.rational_fused:
            return jnp.zeros((s, self._rational_carry), d)
        return (PrestageState(carry=jnp.zeros((s, p.pre_taps - 1), d)),
                PolyState(hist=jnp.zeros((s, self.hist_size), d),
                          hist_len=I32(0),
                          at_hi=I32(p.at0 >> 16), at_lo=I32(p.at0 & 0xFFFF)))

    def core_fn(self):
        """Pure per-topology step ``(state, x) -> (state', y, n)`` (unjitted).

        Used by the sharded engine (parallel.ShardedEngineCore), which
        wraps it in ``shard_map`` over a device mesh; the constants are
        closed over and replicated.
        """
        p = self.plan
        if p.kind == 'cubic':
            step, cap = p.cubic_step, self.cubic_cap

            def fn(state, x):
                st, y, valid, n = stages.cubic_process(state, x, step, cap)
                return st, y, n
            return fn
        if p.kind == 'dft_up':
            if p.factor == 1:
                return lambda state, x: (state, x, I32(x.shape[1]))
            coeffs, f = self.pre_coeffs, p.factor
            prec = self.precision

            def fn(state, x):
                st, u = stages.prestage_process(coeffs, state, x, f, prec)
                return st, u, I32(u.shape[1])
            return fn
        if p.kind == 'decimate':
            if self._decim_fft:
                return partial(_fft_decim_step, self._decim_coeffs_np,
                               p.factor)
            rt, ipx, wx, p2 = (self._decim_rt, self._decim_ipx,
                               self._decim_wx, self._decim_p2)
            return partial(_fused_banded_step, rt, ipx=ipx, wx=wx, p2=p2,
                           precision=self.precision)
        if p.kind == 'banded':
            rt, ipx, wx, p2 = (self._banded_rt, self._banded_ipx,
                               self._banded_wx, self._banded_p2)
            return partial(_fused_banded_step, rt, ipx=ipx, wx=wx, p2=p2,
                           precision=self.precision)
        if self.rational_fused:
            rt, ipx, wx, p2 = (self._rational_rt, self._rational_ipx,
                               self._rational_wx, self._rational_p2)
            return partial(_fused_banded_step, rt, ipx=ipx, wx=wx, p2=p2,
                           precision=self.precision)
        coeffs, banks = self.pre_coeffs, self.banks
        f, L, t2 = p.factor, p.num_phases, p.poly_taps
        s_hi, s_lo, cap = p.step_hi, p.step_lo, self.poly_cap
        prec = self.precision

        def fn(state, x):
            pre_state, poly_state = state
            pre_state, u = stages.prestage_process(coeffs, pre_state, x, f,
                                                   prec)
            poly_state, y, valid, n = stages.poly_process(
                banks, poly_state, u, L, t2, s_hi, s_lo, cap, prec)
            return (pre_state, poly_state), y, n
        return fn

    def _make_step(self):
        p = self.plan
        if p.kind == 'cubic':
            return lambda state, x: _step_cubic(
                state, x, cubic_step=p.cubic_step, cap=self.cubic_cap)
        if p.kind == 'dft_up':
            if p.factor == 1:
                # unity ratio: pass-through (dft_stage.go:57-59)
                return lambda state, x: (state, x, I32(x.shape[1]))
            return lambda state, x: _step_dft_up(
                self.pre_coeffs, state, x, factor=p.factor,
                precision=self.precision)
        if p.kind == 'decimate':
            if self._decim_fft:
                return jax.jit(partial(_fft_decim_step,
                                       self._decim_coeffs_np, p.factor),
                               donate_argnums=0)
            return lambda state, x: _step_decim_fused(
                self._decim_rt, state, x, ipx=self._decim_ipx,
                wx=self._decim_wx, p2=self._decim_p2,
                precision=self.precision)
        if p.kind == 'banded':
            return lambda state, x: _step_rational_fused(
                self._banded_rt, state, x, ipx=self._banded_ipx,
                wx=self._banded_wx, p2=self._banded_p2,
                precision=self.precision)
        if self.rational_fused:
            return lambda state, x: _step_rational_fused(
                self._rational_rt, state, x, ipx=self._rational_ipx,
                wx=self._rational_wx, p2=self._rational_p2,
                precision=self.precision)
        return lambda state, x: _step_two_stage(
            self.pre_coeffs, self.banks, state, x, factor=p.factor,
            num_phases=p.num_phases, taps=p.poly_taps, step_hi=p.step_hi,
            step_lo=p.step_lo, cap=self.poly_cap,
            precision=self.precision)

    def _scan_core(self):
        """Multi-block step: lax.scan of core_fn over SCAN_BLOCKS blocks.

        One device launch processes K blocks ([S, K, B] in,
        ([K, S, cap], n[K]) out), so small-block streaming stops paying
        the per-call dispatch latency per block.  Semantically identical
        to K single-block steps.
        """
        core = self.core_fn()

        def multi(state, xs):                     # xs [S, K, B]
            def body(st, xb):
                st, y, n = core(st, xb)
                return st, (y, n)
            state, (ys, ns) = lax.scan(body, state,
                                       jnp.swapaxes(xs, 0, 1))
            return state, ys, ns                  # [K, S, cap], [K]
        return multi

    def _make_scan(self):
        return jax.jit(self._scan_core(), donate_argnums=0)

    # -- streaming API -----------------------------------------------------

    def reset(self):
        """Clear all streaming state (resampler.go:325-340)."""
        self.state = self._init_state()
        # Input accumulator: the RingBuffer role of the reference pipeline
        # (internal/pipeline/buffer.go:12-172) — amortized-growth FIFO so
        # many small process() chunks do not re-copy the whole backlog.
        self._pending = SampleFIFO(self.batch, capacity=2 * self.block,
                                   dtype=self.dtype)
        self.samples_in = 0       # real input samples fed by the caller
        self.samples_out = 0      # canonical samples emitted to the caller
        self._core_emitted = 0    # core outputs seen (incl. transient prefix)
        self._flushed = False
        # Input prefix buffer for the banded head correction (see _emit).
        self._head_x = None
        if getattr(self, '_banded_head', None) is not None:
            self._head_x = np.zeros((self.batch, 0), dtype=np.float64)
        if self._has_aa:
            self._aa_carry = jnp.zeros(
                (self.batch, self.plan.aa_taps - 1), self.dtype)
            self._aa_raw = SampleFIFO(self.batch, capacity=2 * self.block,
                                      dtype=self.dtype)
            self._aa_causal = 0      # causal FIR outputs produced so far
            self._aa_delivered = 0   # centered samples handed downstream

    # -- strict-antialias prefilter (EnginePlan.aa_coeffs) ------------------

    def _aa_push(self, x: np.ndarray) -> np.ndarray:
        """Stream raw samples through the prefilter; return the centered
        (delay-compensated) filtered samples now available."""
        self._aa_raw.write(x)
        outs = []
        while self._aa_raw.available() >= self.block:
            blk = jnp.asarray(self._aa_raw.read(self.block),
                              dtype=self.dtype)
            self._aa_carry, y = self._fir_fn(self._aa_carry, blk)
            outs.append(np.asarray(y))
        if not outs:
            return np.zeros((self.batch, 0), dtype=self.dtype)
        y = np.concatenate(outs, axis=1)
        skip = min(max(self._aa_delay - self._aa_causal, 0), y.shape[1])
        self._aa_causal += y.shape[1]
        y = y[:, skip:]
        self._aa_delivered += y.shape[1]
        return y

    def _aa_drain(self, extra: int) -> np.ndarray:
        """Flush the prefilter: centered stream totals samples_in + extra.

        ``extra`` is the core's flush padding; filtering it through the
        prefilter (instead of appending raw zeros after a hard truncation
        at samples_in) lets the aa tail extend naturally — the same
        semantics as the composed fused matrix and the numpy oracle."""
        target = self.samples_in + extra
        remaining = target - self._aa_delivered
        if remaining <= 0:
            return np.zeros((self.batch, 0), dtype=self.dtype)
        total = self._aa_raw.available() + extra + self._aa_delay
        zpad = _ceil_div(total, self.block) * self.block \
            - self._aa_raw.available()
        out = self._aa_push(np.zeros((self.batch, zpad), dtype=self.dtype))
        out = out[:, :remaining]
        self._aa_delivered = target
        return out

    def _run_block(self, block_np: np.ndarray) -> np.ndarray:
        x = jnp.asarray(block_np, dtype=self.dtype)
        self.state, y, n = self._step(self.state, x)
        n = int(n)
        return np.asarray(y[:, :n])

    def _emit(self, core_out: np.ndarray, limit: int | None) -> np.ndarray:
        """Apply the transient-prefix drop and the canonical limit."""
        drop = (self._drop_override if self._drop_override is not None
                else self.plan.lengths.drop_prefix())
        start = 0
        if self._core_emitted < drop:
            start = min(drop - self._core_emitted, core_out.shape[1])
        self._core_emitted += core_out.shape[1]
        out = core_out[:, start:]
        if limit is not None:
            room = limit - self.samples_out
            out = out[:, :max(room, 0)]
        if (self._head_x is not None and out.shape[1]
                and self.samples_out < self._banded_head.shape[0]):
            # Banded head correction: the first n_head canonical outputs
            # follow dedicated exact rows (pipeline/fused.py BandedOp.head)
            # instead of the periodic matrix.  Their windows only reach
            # inputs already consumed (same j_max as the periodic rows),
            # so the collected prefix always suffices.
            head = self._banded_head
            k0 = self.samples_out
            k1 = min(head.shape[0], k0 + out.shape[1])
            need = head.shape[1] - self._banded_lam
            xe = np.zeros((self.batch, head.shape[1]))
            have = min(need, self._head_x.shape[1])
            xe[:, self._banded_lam:self._banded_lam + have] = \
                self._head_x[:, :have]
            out = np.array(out)
            out[:, :k1 - k0] = (xe @ head[k0:k1].T).astype(self.dtype)
        self.samples_out += out.shape[1]
        return out

    def process(self, x: np.ndarray) -> np.ndarray:
        """Resample a chunk; returns all output currently available.

        ``x`` is [batch, n] (or [n] for batch==1).  Per-call output counts
        differ from the reference (full micro-blocks are processed eagerly,
        the tail is held until more input or flush), but the concatenated
        stream is canonical.
        """
        if self._flushed:
            raise RuntimeError("process() after flush(); call reset() first")
        x = np.asarray(x, dtype=self.dtype)
        if x.ndim == 1:
            x = np.broadcast_to(x, (self.batch, x.shape[0])) if self.batch > 1 \
                else x[None, :]
        if x.shape[0] != self.batch:
            raise ValueError(f"expected {self.batch} streams, got {x.shape[0]}")
        self.samples_in += x.shape[1]
        if self._head_x is not None:
            need = self._banded_head.shape[1] - self._banded_lam
            if self._head_x.shape[1] < need:
                take = min(need - self._head_x.shape[1], x.shape[1])
                self._head_x = np.concatenate(
                    [self._head_x, np.asarray(x[:, :take], dtype=np.float64)],
                    axis=1)
        if self._has_aa:
            x = self._aa_push(x)
        self._pending.write(x)
        outs = []
        k_scan = self.SCAN_BLOCKS
        while self._pending.available() >= self.block:
            if self._pending.available() >= k_scan * self.block:
                xs = self._pending.read(k_scan * self.block) \
                    .reshape(self.batch, k_scan, self.block)
                if self._scan_step is None:
                    self._scan_step = self._make_scan()
                self.state, ys, ns = self._scan_step(
                    self.state, jnp.asarray(xs, dtype=self.dtype))
                ys = np.asarray(ys)
                ns = np.asarray(ns)
                for k in range(k_scan):
                    outs.append(self._emit(ys[k][:, :int(ns[k])], None))
            else:
                blk = self._pending.read(self.block)
                outs.append(self._emit(self._run_block(blk), None))
        if outs:
            return np.concatenate(outs, axis=1)
        return np.zeros((self.batch, 0), dtype=self.dtype)

    # -- device-resident streaming (serving / ML-ingest path) ---------------

    @property
    def device_chunk_multiple(self) -> int | None:
        """Input-chunk granularity for :meth:`process_device`.

        The fused input period for the banded topologies, 1 for the DFT
        upsample; ``None`` when the topology has data-dependent output
        counts (cubic, non-exact polyphase walk) and only :meth:`process`
        is available.
        """
        p = self.plan
        if p.kind == 'dft_up':
            return 1
        if p.kind == 'decimate':
            return self._decim_ipx
        if p.kind == 'banded':
            return self._banded_ipx
        if p.kind == 'two_stage' and self.rational_fused:
            return self._rational_ipx
        return None

    def _device_params(self) -> tuple[int, int]:
        """(input period, outputs per period) for the static-count step."""
        p = self.plan
        if p.kind == 'dft_up':
            return 1, p.factor
        if p.kind == 'decimate':
            return self._decim_ipx, self._decim_p2
        if p.kind == 'banded':
            return self._banded_ipx, self._banded_p2
        return self._rational_ipx, self._rational_p2

    def _put_batch(self, arr: jax.Array) -> jax.Array:
        """Placement hook for device-mode batch-axis intermediates.

        Identity here; ShardedEngineCore shards axis 0 over its mesh so
        the head-corrected output stays sharded like the step output.
        """
        return arr

    def _head_x_device(self) -> jax.Array:
        """The collected banded-head input prefix as a device array."""
        hx = self._head_x
        if isinstance(hx, jax.Array):
            return hx.astype(self.dtype)
        return jnp.asarray(np.asarray(hx, dtype=self.dtype))

    def _emit_device(self, core_out: jax.Array, n_out: int,
                     limit: int | None) -> jax.Array:
        """Device-mode twin of :meth:`_emit` (keep the two in sync).

        All slice bounds are host-known (static counts), so nothing here
        synchronizes with the device.  The banded head rows are applied
        in the engine dtype on device; the host path computes them in
        float64 — on float32 engines the first n_head samples may differ
        across modes at the f32 rounding level.
        """
        drop = (self._drop_override if self._drop_override is not None
                else self.plan.lengths.drop_prefix())
        start = 0
        if self._core_emitted < drop:
            start = min(drop - self._core_emitted, n_out)
        self._core_emitted += n_out
        out = core_out[:, start:n_out]
        if limit is not None:
            room = limit - self.samples_out
            out = out[:, :max(room, 0)]
        if (self._head_x is not None and out.shape[1]
                and self.samples_out < self._banded_head.shape[0]):
            head = self._banded_head
            k0 = self.samples_out
            k1 = min(head.shape[0], k0 + out.shape[1])
            need = head.shape[1] - self._banded_lam
            hx = self._head_x_device()[:, :need]
            xe = jnp.zeros((self.batch, head.shape[1]), self.dtype)
            xe = xe.at[:, self._banded_lam:
                       self._banded_lam + hx.shape[1]].set(hx)
            xe = self._put_batch(xe)
            hm = jnp.asarray(np.asarray(head[k0:k1].T, dtype=self.dtype))
            corr = jnp.matmul(xe, hm, precision=lax.Precision.HIGHEST)
            out = jnp.concatenate([corr.astype(self.dtype),
                                   out[:, k1 - k0:]], axis=1)
        self.samples_out += out.shape[1]
        return out

    def process_device(self, x) -> jax.Array:
        """Resample a chunk entirely on device; returns a ``jax.Array``.

        The serving-path alternative to :meth:`process`: the input is (or
        is uploaded to) a device array, the whole chunk runs as ONE
        device launch, and the output stays device-resident with NO host
        synchronization — output counts are static for the supported
        topologies, so every slice bound is host-known and the caller
        chains further device work (ML ingest) or downloads at its own
        cadence.  This is the mode the committed
        ``streaming_device_e2e_*`` benchmark rows measure; the
        host-download ``streaming_e2e_*`` rows pay a per-block device->
        host bounce instead (benchmarks/README.md).

        Supported topologies (static output counts): fused exact-rational
        two-stage, decimate, banded composite, DFT upsample.  The chunk
        width must be a multiple of :attr:`device_chunk_multiple`; widths
        may vary call to call (each distinct width compiles once).  May
        be mixed with :meth:`process` whenever no host-side input is
        buffered there (feed block multiples, or reset()).
        """
        mult = self.device_chunk_multiple
        if mult is None:
            raise NotImplementedError(
                f"process_device: topology {self.plan.kind!r} has "
                "data-dependent output counts; use process()")
        if self._flushed:
            raise RuntimeError("process() after flush(); call reset() first")
        if self._pending.available():
            raise RuntimeError(
                "process_device: host-buffered input pending from a prior "
                "process() call; feed block multiples there, or reset()")
        x = jnp.asarray(x, dtype=self.dtype)
        if x.ndim == 1:
            x = (jnp.broadcast_to(x, (self.batch, x.shape[0]))
                 if self.batch > 1 else x[None, :])
        if x.shape[0] != self.batch:
            raise ValueError(f"expected {self.batch} streams, got {x.shape[0]}")
        n = int(x.shape[1])
        if n % mult:
            raise ValueError(
                f"process_device chunk width {n} is not a multiple of "
                f"device_chunk_multiple={mult}")
        if n == 0:
            return jnp.zeros((self.batch, 0), self.dtype)
        self.samples_in += n
        if self._head_x is not None:
            need = self._banded_head.shape[1] - self._banded_lam
            if self._head_x.shape[1] < need:
                take = min(need - self._head_x.shape[1], n)
                self._head_x = jnp.concatenate(
                    [self._head_x_device(), x[:, :take]], axis=1)
        self.state, y, _n = self._step(self.state, x)
        ipx, p2 = self._device_params()
        return self._emit_device(y, (n // ipx) * p2, None)

    def flush_device(self) -> jax.Array:
        """Drain all stage tails on device; returns a ``jax.Array``.

        Device-mode counterpart of :meth:`flush` for the
        :meth:`process_device`-supported topologies: static output counts
        keep the drain loop host-decidable, so the flush never
        synchronizes with the device either.
        """
        mult = self.device_chunk_multiple
        if mult is None:
            raise NotImplementedError(
                f"flush_device: topology {self.plan.kind!r} has "
                "data-dependent output counts; use flush()")
        if self._flushed:
            return jnp.zeros((self.batch, 0), self.dtype)
        self._flushed = True
        lm = self.plan.lengths
        canonical_total = lm.canonical(self.samples_in)
        z = lm.flush_pad(self.samples_in) if self.samples_in > 0 else 0
        rem = self._pending.available()
        total_tail = rem + z
        ipx, p2 = self._device_params()
        outs = []
        if total_tail:
            n1 = _ceil_div(total_tail, mult) * mult
            tail = np.zeros((self.batch, n1), dtype=self.dtype)
            if rem:
                tail[:, :rem] = self._pending.read_all()
            self.state, y, _n = self._step(self.state, jnp.asarray(tail))
            outs.append(self._emit_device(y, (n1 // ipx) * p2,
                                          canonical_total))
        guard, limit = 0, self._flush_extra_limit()
        zeros_blk = None
        while self.samples_out < canonical_total:
            if zeros_blk is None:
                zeros_blk = jnp.zeros((self.batch, self.block), self.dtype)
            self.state, y, _n = self._step(self.state, zeros_blk)
            outs.append(self._emit_device(y, (self.block // ipx) * p2,
                                          canonical_total))
            guard += 1
            if guard > limit:
                raise AssertionError(
                    "internal: flush under-produced "
                    f"({self.samples_out} < {canonical_total}) after "
                    f"{guard} extra blocks (limit {limit})")
        if outs:
            return jnp.concatenate(outs, axis=1)
        return jnp.zeros((self.batch, 0), self.dtype)

    def stream(self, chunks, out: str = 'host'):
        """Pipelined streaming over an iterable of chunks (generator).

        The host-loop twin of :meth:`process_device` for callers that live
        in numpy: each input chunk is uploaded and dispatched immediately
        (JAX dispatch is asynchronous), but the device->host download of
        chunk k is deferred until chunk k+1 has been dispatched — so the
        transfer of one chunk overlaps the device compute of the next,
        and the device never idles during a download.  The reference's
        synchronous 65536-sample CLI loop (cmd/resample-wav/main.go:270-339)
        pays read->compute->write serially per chunk; here the three
        phases pipeline.

        ``chunks`` yields arrays of ANY widths ([batch, n] or [n] for
        batch==1); a host-side remainder buffer carves them into
        :attr:`device_chunk_multiple` granules.  Yields the resampled
        stream in order, ending with the flush tail; the concatenation is
        canonically identical to ``process(all)+flush()`` — except that on
        float32 banded-composite engines the first ``n_head`` samples may
        differ at the f32 rounding level, because the device route applies
        the exact head rows in the engine dtype while the host path
        computes them in float64 (see :meth:`_emit_device`).

        ``out='host'`` yields ``np.ndarray``; ``out='device'`` yields
        ``jax.Array`` without ever downloading (the caller owns sync
        cadence — requires a device-mode topology).  Topologies without
        static output counts (cubic, non-exact polyphase) fall back to
        the synchronous host path for ``out='host'``.
        """
        if out not in ('host', 'device'):
            raise ValueError(f"out must be 'host' or 'device', got {out!r}")
        mult = self.device_chunk_multiple
        if mult is None:
            if out == 'device':
                raise NotImplementedError(
                    f"stream(out='device'): topology {self.plan.kind!r} "
                    "has data-dependent output counts; use out='host'")
            for x in chunks:
                y = self.process(x)
                if y.shape[1]:
                    yield y
            tail = self.flush()
            if tail.shape[1]:
                yield tail
            return

        yield from pipelined_stream(self, chunks, out, mult)

    def _flush_extra_limit(self) -> int:
        """Max extra zero blocks flush may legally need (exact holdback).

        Per topology, the core's internal history bounds how much input it
        can hold back without emitting: the banded carries for the fused
        rational/decimate steps, ``hist_size`` for the general poly walk,
        the prestage carry for DFT up, and the 3-sample window for cubic;
        plus the strict-antialias prefilter's group delay when present."""
        p = self.plan
        if p.kind == 'cubic':
            hold = 4
        elif p.kind == 'dft_up':
            hold = max(p.pre_taps - 1, 0)
        elif p.kind == 'decimate':
            hold = self._decim_carry + self._decim_wx
        elif p.kind == 'banded':
            hold = self._banded_carry + self._banded_wx
        elif self.rational_fused:
            hold = self._rational_carry + self._rational_wx
        else:
            hold = self.hist_size
        if self._has_aa:
            hold += 2 * self._aa_delay
        return _ceil_div(hold, self.block) + 2

    def flush(self) -> np.ndarray:
        """Drain all stage tails; returns the remaining canonical samples.

        Mirrors resampler.go:275-322 through the length model: the core is
        fed the exact zero padding that drains every stage, and the stream
        is trimmed to the canonical total.
        """
        if self._flushed:
            return np.zeros((self.batch, 0), dtype=self.dtype)
        self._flushed = True
        lm = self.plan.lengths
        canonical_total = lm.canonical(self.samples_in) + 0
        z = lm.flush_pad(self.samples_in) if self.samples_in > 0 else 0
        if self._has_aa:
            # Run the flush padding THROUGH the prefilter so the core sees
            # aa(x ++ 0^z) — the aa tail extends into the padding (same
            # semantics as the fused matrix and the one-shot path).
            self._pending.write(self._aa_drain(z))
            z = 0
        rem = self._pending.available()
        # Feed remainder + z zeros, rounded up to whole blocks (extra zeros
        # only produce post-canonical samples, which the limit trims).
        total_tail = rem + z
        n_blocks = _ceil_div(total_tail, self.block) if total_tail else 0
        tail = np.zeros((self.batch, n_blocks * self.block), dtype=self.dtype)
        if rem:
            tail[:, :rem] = self._pending.read_all()
        outs = []
        for i in range(n_blocks):
            blk = tail[:, i * self.block:(i + 1) * self.block]
            outs.append(self._emit(self._run_block(blk), canonical_total))
        # Some cores (e.g. the fused-rational step with its block-granular
        # emission) need a few extra zero blocks to reach the canonical
        # count.  The bound is exact: the core can hold back at most its
        # internal history (per-topology, in input samples), so anything
        # beyond ceil(holdback/block)+2 blocks is a length-model bug —
        # fail loudly instead of absorbing it.
        guard, limit = 0, self._flush_extra_limit()
        while self.samples_out < canonical_total:
            zeros_blk = np.zeros((self.batch, self.block), dtype=self.dtype)
            outs.append(self._emit(self._run_block(zeros_blk),
                                   canonical_total))
            guard += 1
            if guard > limit:
                raise AssertionError(
                    "internal: flush under-produced "
                    f"({self.samples_out} < {canonical_total}) after "
                    f"{guard} extra blocks (limit {limit})")
        if outs:
            out = np.concatenate(outs, axis=1)
        else:
            out = np.zeros((self.batch, 0), dtype=self.dtype)
        return out

    # -- introspection (resample.go:339-355, resampler.go:342-353) ---------

    def get_ratio(self) -> float:
        return self.plan.ratio

    def get_latency(self) -> int:
        return self.plan.latency()

    def estimate_output(self, n: int) -> int:
        return self.plan.estimate_output(n)

    def get_statistics(self) -> dict:
        return {"samplesIn": self.samples_in, "samplesOut": self.samples_out}
