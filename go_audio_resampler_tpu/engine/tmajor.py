"""Time-major device serving: samples on rows, streams on columns.

The stream-major serving step (``EngineCore``) stores ``[streams,
samples]`` and computes ``frames[S, F, Wx] @ R^T[Wx, P2]``.  Stored
TIME-MAJOR (``[samples, streams]``) the same step becomes
``R[P2, Wx] @ window[Wx, S]`` per frame: the row windows of
``[carry ++ block]`` are gathered as ``[F, Wx, S]`` and one
``einsum('pw,fws->fps')`` emits ``[F*P2, S]`` with no transpose anywhere.

Time-major is not an exotic layout: interleaved multi-channel audio IS
[samples, channels], so an ingest pipeline feeding interleaved frames
can use this engine with no transpose.  Device-resident serving only
(process_device/flush_device twins of EngineCore's); the host-FIFO paths
stay on the stream-major engine.

Reference anchor: the hot loop is the same fused two-stage cascade
(engine/resampler.go:86-176 topologies) — the layout freedom has no Go
counterpart.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.precision import dot_precision
from .plan import EnginePlan
from .streaming import EngineCore, _ceil_div

I32 = jnp.int32


def _tmajor_frames_apply(data, r, ipx, wx, p2, n_frames,
                         precision: str = 'auto'):
    """Row windows at j*ipx of width wx times r [P2, Wx] -> [F*P2, S].

    ``data`` [N, S] is time-major; frame j reads rows
    ``data[j*ipx : j*ipx + wx]`` (the same canonical grid as the
    stream-major ``_banded_frames_apply``), gathered as [F, Wx, S] so the
    streams stay on the minor axis through the matmul.
    """
    s = data.shape[1]
    starts = lax.iota(I32, n_frames) * I32(ipx)
    idx = starts[:, None] + lax.iota(I32, wx)[None, :]
    idx = jnp.clip(idx, 0, data.shape[0] - 1)
    frames = jnp.take(data, idx, axis=0)                 # [F, Wx, S]
    y = jnp.einsum('pw,fws->fps', r.astype(data.dtype), frames,
                   preferred_element_type=data.dtype,
                   precision=dot_precision(precision))
    return y.reshape(n_frames * p2, s)


@partial(jax.jit, static_argnames=('ipx', 'wx', 'p2', 'precision'),
         donate_argnames=('carry',))
def _step_banded_tmajor(r, carry, x, ipx, wx, p2, precision='auto'):
    """Time-major twin of _fused_banded_step: [C+B, S] rows -> frames.

    ``r`` [P2, Wx] (NOT transposed — it is the matmul LHS here);
    ``carry`` [C, S]; ``x`` [B, S] with B % ipx == 0.  Window j reads
    rows [carry ++ x][j*ipx : j*ipx + wx] — the same canonical grid as
    the stream-major step, so outputs agree modulo matmul summation
    order.  Emits exactly (B/ipx)*P2 rows.
    """
    b = x.shape[0]
    n_frames = b // ipx
    data = jnp.concatenate([carry.astype(x.dtype), x], axis=0)
    y = _tmajor_frames_apply(data, r, ipx, wx, p2, n_frames, precision)
    return data[b:], y, I32(n_frames * p2)


class TimeMajorEngine:
    """Device-resident streaming resampler over time-major arrays.

    ``process_device(xt)`` takes a [samples, streams] jax.Array whose
    row count is a multiple of :attr:`chunk_multiple` and returns the
    resampled [out_samples, streams] device array with ZERO host
    synchronization (static output counts, like
    ``EngineCore.process_device``).  ``flush_device`` drains the exact
    canonical tail.  Output rows equal ``EngineCore``'s output columns
    for the same plan (transpose equivalence, modulo f32 summation
    order inside the matmul) — tests/test_tmajor.py pins both.

    Supported topologies: the fused banded families with static counts
    and no aperiodic head — exact-rational two-stage, integer decimate
    (matmul routing), head-free banded composites.
    """

    def __init__(self, plan: EnginePlan, batch: int = 1, block: int = 2048,
                 dtype=jnp.float32, precision: str = 'auto'):
        # Reuse EngineCore's constant baking (fused matrices, superframe,
        # carry/drop arithmetic, length model) — construction compiles
        # nothing; this engine only swaps the step's data layout.
        eng = EngineCore(plan, batch=batch, block=block, dtype=dtype,
                         precision=precision)
        if eng.device_chunk_multiple is None or plan.kind == 'dft_up':
            raise NotImplementedError(
                f"TimeMajorEngine: topology {plan.kind!r} is not a fused "
                "banded step; use EngineCore")
        if plan.kind == 'decimate' and eng._decim_fft:
            raise NotImplementedError(
                "TimeMajorEngine: FFT-routed decimation has no banded "
                "matrix; use EngineCore")
        if plan.kind == 'banded' and eng._banded_head.shape[0]:
            raise NotImplementedError(
                "TimeMajorEngine: banded composites with an aperiodic "
                "head are not supported; use EngineCore.process_device")
        self.plan = plan
        self.batch = batch
        self.dtype = jnp.dtype(dtype)
        self.block = eng.block
        self.precision = precision
        if plan.kind == 'decimate':
            rt, self._ipx, self._wx, self._p2 = (
                eng._decim_rt, eng._decim_ipx, eng._decim_wx, eng._decim_p2)
            self._carry_len = eng._decim_carry
        elif plan.kind == 'banded':
            rt, self._ipx, self._wx, self._p2 = (
                eng._banded_rt, eng._banded_ipx, eng._banded_wx,
                eng._banded_p2)
            self._carry_len = eng._banded_carry
        else:
            rt, self._ipx, self._wx, self._p2 = (
                eng._rational_rt, eng._rational_ipx, eng._rational_wx,
                eng._rational_p2)
            self._carry_len = eng._rational_carry
        self._r = jnp.asarray(rt.T)          # [P2, Wx], matmul LHS
        self._drop = (eng._drop_override
                      if eng._drop_override is not None
                      else plan.lengths.drop_prefix())
        self._lengths = plan.lengths
        self._flush_limit = eng._flush_extra_limit()
        self.reset()

    @property
    def chunk_multiple(self) -> int:
        """Row granularity of :meth:`process_device` chunks."""
        return self._ipx

    def reset(self) -> None:
        self._carry = jnp.zeros((self._carry_len, self.batch), self.dtype)
        self.samples_in = 0
        self.samples_out = 0
        self._core_emitted = 0
        self._flushed = False

    def estimate_output(self, n: int) -> int:
        return self.plan.estimate_output(n)

    def _emit(self, y: jax.Array, n_out: int, limit: int | None):
        start = 0
        if self._core_emitted < self._drop:
            start = min(self._drop - self._core_emitted, n_out)
        self._core_emitted += n_out
        out = y[start:n_out, :]
        if limit is not None:
            room = limit - self.samples_out
            out = out[:max(room, 0), :]
        self.samples_out += out.shape[0]
        return out

    def process_device(self, xt) -> jax.Array:
        """[n, S] device rows in -> [m, S] device rows out, no syncs."""
        if self._flushed:
            raise RuntimeError("process after flush; call reset() first")
        xt = jnp.asarray(xt, dtype=self.dtype)
        if xt.ndim != 2 or xt.shape[1] != self.batch:
            raise ValueError(
                f"expected [n, {self.batch}] time-major rows, "
                f"got {getattr(xt, 'shape', None)}")
        n = int(xt.shape[0])
        if n % self._ipx:
            raise ValueError(
                f"chunk rows {n} not a multiple of "
                f"chunk_multiple={self._ipx}")
        if n == 0:
            return jnp.zeros((0, self.batch), self.dtype)
        self.samples_in += n
        self._carry, y, _n = _step_banded_tmajor(
            self._r, self._carry, xt, ipx=self._ipx, wx=self._wx,
            p2=self._p2, precision=self.precision)
        return self._emit(y, (n // self._ipx) * self._p2, None)

    def flush_device(self) -> jax.Array:
        """Drain the canonical tail (EngineCore.flush_device twin)."""
        if self._flushed:
            return jnp.zeros((0, self.batch), self.dtype)
        self._flushed = True
        canonical_total = self._lengths.canonical(self.samples_in)
        z = (self._lengths.flush_pad(self.samples_in)
             if self.samples_in > 0 else 0)
        outs = []
        if z:
            n1 = _ceil_div(z, self._ipx) * self._ipx
            tail = jnp.zeros((n1, self.batch), self.dtype)
            self._carry, y, _n = _step_banded_tmajor(
                self._r, self._carry, tail, ipx=self._ipx, wx=self._wx,
                p2=self._p2, precision=self.precision)
            outs.append(self._emit(y, (n1 // self._ipx) * self._p2,
                                   canonical_total))
        guard = 0
        while self.samples_out < canonical_total:
            blk = jnp.zeros((self.block, self.batch), self.dtype)
            self._carry, y, _n = _step_banded_tmajor(
                self._r, self._carry, blk, ipx=self._ipx, wx=self._wx,
                p2=self._p2, precision=self.precision)
            outs.append(self._emit(y, (self.block // self._ipx) * self._p2,
                                   canonical_total))
            guard += 1
            if guard > self._flush_limit:
                raise AssertionError(
                    "internal: flush under-produced "
                    f"({self.samples_out} < {canonical_total})")
        if outs:
            return jnp.concatenate(outs, axis=0)
        return jnp.zeros((0, self.batch), self.dtype)
