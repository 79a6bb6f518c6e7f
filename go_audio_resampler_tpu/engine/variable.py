"""Variable-rate resampling: the libsoxr ``SOXR_VR`` capability.

Beyond-reference breadth: the Go reference (tphakala/go-audio-resampler)
implements only constant-rate conversion; libsoxr additionally offers a
variable-rate mode (``soxr_set_io_ratio`` with linear slew) used for
glissandi, clock-drift correction and live rate tracking.  This module
provides that capability on the device.

Design (matches the framework's host-plans/device-computes split):

- The **host** owns the exact position walk.  Output k reads input
  position ``p_k``; the io-ratio ``r`` (input samples per output sample)
  slews linearly toward the target set by
  :meth:`VariableRateResampler.set_io_ratio`.  Positions are a CLOSED
  FORM of the output index from the last ratio event ("anchor"):
  ``p(k) = anchor + su*k + du*k(k-1)/2`` during a slew, linear after —
  never an accumulated sum — so the emitted stream is bit-exact
  invariant to input chunking, and anchors rebase only at deterministic
  points (ratio events, slew completion, fixed k thresholds).  This
  mirrors how the constant-rate engine bakes its exact walk at trace
  time — except here the walk is data, not a trace constant, so **one
  compiled program serves every ratio trajectory** (no recompilation
  when the ratio changes).
- The **device** runs a single static-shape program per block: gather the
  4-sample windows at the host-computed indices from [carry | block] and
  evaluate the SOXR cr-core cubic (stages.hermite4), masked by validity.
  Batched streams ride the leading axis as everywhere else.

Two quality modes:

- ``'vr'``  — 4-point cubic straight on the input stream (libsoxr VR
  class: cubic interpolation).
- ``'vr-hq'`` — the input is first 2x-upsampled with the engine's DFT
  half-band prestage (filterdesign.design_dft_upsample), then the cubic
  walk runs on the image-free 2x stream, cutting interpolation error by
  the image attenuation of the half-band.  The prestage group delay is
  compensated in the position model, so both modes are time-aligned.

Reference anchors: cubic kernel parity with cubic.go:75-90 (via
stages.hermite4); the prestage is dft_stage.go:156-338's filter.  The
API shape (io_ratio, linear slew over N outputs) follows soxr.h
soxr_set_io_ratio.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..filterdesign import params as fdp
from ..ops.precision import dot_precision
from .stages import gather_windows, prestage_apply

MIN_IO_RATIO = 1.0 / 256.0
MAX_IO_RATIO = 256.0


#: outputs per on-device banded tile (lane width)
VR_TILE = 128


def _cubic_basis(fr):
    """Catmull-Rom basis weights K0..K3 at fraction ``fr`` (stacked last).

    The per-tap expansion of stages.hermite4 (cubic.go:75-90): pushing
    unit taps through its a/b/c algebra gives, exactly,
      K0 = ((-f/6 + 1/2)f - 1/3)f          K1 = ((f/2 - 1)f - 1/2)f + 1
      K2 = ((-f/2 + 1/2)f + 1)f            K3 = ((f/6)f - 1/6)f
    At f == 0 this is the exact one-hot (0,1,0,0), so integer positions
    reproduce input samples bit-for-bit through the matmul.
    """
    one = jnp.ones((), fr.dtype)
    k0 = ((-fr / 6.0 + 0.5) * fr - (1.0 / 3.0)) * fr
    k1 = ((fr / 2.0 - 1.0) * fr - 0.5) * fr + one
    k2 = ((-fr / 2.0 + 0.5) * fr + 1.0) * fr
    k3 = ((fr / 6.0) * fr - (1.0 / 6.0)) * fr
    return jnp.stack([k0, k1, k2, k3], axis=-1)


@partial(jax.jit, static_argnames=('factor', 'span'))
def _vr_scan(carry, pre_carry, coeffs, xs, idx, frac, valid, *,
             factor: int, span: int):
    """All blocks of one call in a single device program (lax.scan).

    ``xs`` [K, S, B] input blocks, ``idx`` [K, cap] int32 window starts
    into each block's u-histbuf (pre-clipped), ``frac`` [K, cap]
    fractions, ``valid`` [K, cap] 0/1 masks.  With ``factor > 1`` the 2x
    half-band prestage runs inside the scan body (its carry rides the
    scan state), so a process() call is ONE device launch regardless of
    block count.  The scan body is compiled once per (factor, shapes,
    span), so per-block results are bitwise independent of the scan
    length (chunking invariance holds through it).

    The interpolation is a banded tile matmul built ON DEVICE: per tile
    of VR_TILE outputs the 4-tap windows span at most ``span`` samples
    (host-measured, bucketed), so the tile's operator is a [VR_TILE,
    span] matrix assembled from the cubic basis with iota one-hots — one
    wide gather per TILE plus one matmul instead of a per-OUTPUT
    dynamic gather.

    Returns (carry' [S,3], pre_carry', ys [K, S, cap], invalid zeroed).
    """
    cap = idx.shape[1]
    n_t = cap // VR_TILE

    def body(cs, inp):
        c, pc = cs
        x, i, f, v = inp
        if factor > 1:
            xext = jnp.concatenate([pc.astype(x.dtype), x], axis=1)
            u = prestage_apply(coeffs, xext, factor)
            pc2 = xext[:, x.shape[1]:]
        else:
            u, pc2 = x, pc
        histbuf = jnp.concatenate([c.astype(u.dtype), u], axis=1)
        idx_t = i.reshape(n_t, VR_TILE)
        i0 = idx_t[:, 0]                                   # [n_t]
        rel = jnp.clip(idx_t - i0[:, None], 0, span - 4)   # [n_t, TV]
        k = _cubic_basis(f.astype(u.dtype).reshape(n_t, VR_TILE))
        lanes = jax.lax.iota(jnp.int32, span)[None, None, :]
        b = jnp.zeros((n_t, VR_TILE, span), u.dtype)
        for t in range(4):
            b = b + k[..., t, None] * (lanes == (rel + t)[..., None])
        tiles = gather_windows(histbuf, i0, span)          # [S, n_t, span]
        y = jnp.einsum('stw,tpw->stp', tiles, b,
                       preferred_element_type=u.dtype,
                       precision=dot_precision())
        y = y.reshape(x.shape[0], cap) * v.astype(u.dtype)[None, :]
        return (histbuf[:, -3:], pc2), y

    (c2, pc2), ys = jax.lax.scan(body, (carry, pre_carry),
                                 (xs, idx, frac, valid))
    return c2, pc2, ys


class VariableRateResampler:
    """Streaming variable-rate resampler (soxr.h variable-rate analog).

    Parameters
    ----------
    max_ratio:
        Upper bound on the *output/input* rate ratio ever requested
        (soxr requires the same bound at create time for VR); sizes the
        per-block output capacity.  Must lie in [1/256, 256].
    io_ratio:
        Initial input-samples-per-output-sample ratio (soxr convention:
        ``input_rate / output_rate``).
    batch:
        Number of independent streams on the leading axis.
    block:
        Internal device block size in input samples.
    quality:
        ``'vr'`` (cubic on the input) or ``'vr-hq'`` (cubic on a 2x
        half-band upsampled stream).
    """

    PRESTAGE_FACTOR = 2

    def __init__(self, max_ratio: float, io_ratio: float = 1.0, *,
                 batch: int = 1, block: int = 2048, dtype=np.float32,
                 quality: str = 'vr'):
        if not (MIN_IO_RATIO <= max_ratio <= MAX_IO_RATIO):
            raise ValueError("max_ratio out of [1/256, 256]")
        if quality not in ('vr', 'vr-hq'):
            raise ValueError("quality must be 'vr' or 'vr-hq'")
        self.max_ratio = float(max_ratio)
        self.batch = int(batch)
        self.block = int(block)
        self.dtype = np.dtype(dtype)
        self.quality = quality

        self.factor = self.PRESTAGE_FACTOR if quality == 'vr-hq' else 1
        if quality == 'vr-hq':
            pre = fdp.design_dft_upsample(self.factor, fdp.Quality.HIGH)
            self._pre_coeffs = jnp.asarray(pre.phase_coeffs,
                                           dtype=self.dtype)
            self._pre_t1 = pre.taps_per_phase
            # u[j] carries input time (j - delay_u) / factor: each phase
            # FIR spans T1 inputs (center (T1-1)/2), so on the u grid the
            # group delay is factor*(T1-1)/2 (integer for factor 2).
            self._delay_u = self.factor * (self._pre_t1 - 1) // 2
        else:
            self._pre_coeffs = None
            self._pre_t1 = 1
            self._delay_u = 0

        # Output capacity per input block: outputs per input sample is
        # bounded by max_ratio regardless of the prestage factor.  Rounded
        # up to whole VR_TILE device tiles (the banded-matmul lane width).
        self.cap = -(-(int(math.ceil(self.block * self.max_ratio)) + 4)
                     // VR_TILE) * VR_TILE

        self._validate_ratio(io_ratio)
        # The initial ratio must respect max_ratio exactly like every
        # set_io_ratio() target: the per-block output capacity is sized
        # from max_ratio, so a faster initial ratio would overflow the
        # walk mid-process (an internal AssertionError) instead of
        # failing loudly here at construction.
        if 1.0 / io_ratio > self.max_ratio + 1e-12:
            raise ValueError(
                f"initial io_ratio {io_ratio} exceeds max_ratio "
                f"{self.max_ratio} (output/input {1.0 / io_ratio:.4f})")
        self._init_r = float(io_ratio)
        self.reset()

    # -- ratio control ----------------------------------------------------

    @staticmethod
    def _validate_ratio(io_ratio: float) -> None:
        if not (MIN_IO_RATIO <= io_ratio <= MAX_IO_RATIO):
            raise ValueError("io_ratio out of [1/256, 256]")

    def set_io_ratio(self, io_ratio: float, slew_len: int = 0) -> None:
        """Change the in/out ratio, slewing over ``slew_len`` outputs.

        soxr.h soxr_set_io_ratio semantics: with slew_len == 0 the change
        is immediate; otherwise the ratio moves linearly to the target
        over the next ``slew_len`` emitted output samples.
        """
        self._validate_ratio(io_ratio)
        if 1.0 / io_ratio > self.max_ratio + 1e-12:
            raise ValueError(
                f"io_ratio {io_ratio} exceeds construction-time max_ratio "
                f"{self.max_ratio} (output/input {1.0 / io_ratio:.4f})")
        su_cur = self._step_at(self._k)   # current per-output u step
        self._rebase()                    # anchor at the ratio event
        target_su = float(self.factor) * float(io_ratio)
        if slew_len <= 0:
            self._su = target_su
            self._du = 0.0
            self._slew_n = 0
        else:
            self._su = su_cur
            self._du = (target_su - su_cur) / float(slew_len)
            self._slew_n = int(slew_len)
        self._su_end = target_su

    def get_io_ratio(self) -> float:
        return self._step_at(self._k) / float(self.factor)

    # -- closed-form position model ---------------------------------------
    #
    # From the last anchor (output index k = 0 at u position _anchor):
    #   k <= _slew_n:  p(k) = anchor + su*k + du*k(k-1)/2,
    #                  step(k) = su + k*du
    #   k >  _slew_n:  p(k) = p(_slew_n) + su_end*(k - _slew_n),
    #                  step(k) = su_end
    # Positions are always evaluated from (anchor, k) — never accumulated
    # sample-to-sample — so chunking cannot perturb rounding.

    _REBASE_K = 1 << 20

    def _step_at(self, k: int) -> float:
        if k < self._slew_n:
            return self._su + k * self._du
        return self._su_end

    def _pos_at(self, k: float) -> float:
        if k <= self._slew_n:
            return self._anchor + self._su * k + self._du * (k * (k - 1.0)
                                                             / 2.0)
        ps = self._anchor + self._su * self._slew_n \
            + self._du * (self._slew_n * (self._slew_n - 1.0) / 2.0)
        return ps + self._su_end * (k - self._slew_n)

    def _rebase(self) -> None:
        """Re-anchor the closed form at the current output index."""
        self._anchor = self._pos_at(self._k)
        if self._k >= self._slew_n:
            self._su = self._su_end
            self._du = 0.0
            self._slew_n = 0
        else:
            self._su = self._step_at(self._k)
            self._slew_n -= self._k
        self._k = 0

    # -- state ------------------------------------------------------------

    def reset(self) -> None:
        self._hold = np.zeros((self.batch, 0), dtype=self.dtype)
        self._carry = jnp.zeros((self.batch, 3), dtype=self.dtype)
        # 'vr' mode carries an empty prestage state through the scan.
        pre_w = self._pre_t1 - 1 if self.quality == 'vr-hq' else 0
        self._pre_carry = jnp.zeros((self.batch, pre_w), dtype=self.dtype)
        # Output at input time t sits at u position factor*t + delay_u;
        # the first output is at input time 0.
        self._anchor = float(self._delay_u)
        self._k = 0                       # outputs since the anchor
        self._su = float(self.factor) * self._init_r
        self._su_end = self._su
        self._du = 0.0
        self._slew_n = 0
        self._u_fed = 0                   # u-samples fed to the device
        self._in_fed = 0                  # input samples fed so far
        self.samples_in = 0
        self.samples_out = 0

    # -- host walk --------------------------------------------------------

    def _walk(self, data_u: int, pos_limit: float):
        """Emit positions while the 4-sample window is covered by the fed
        u-stream (floor(p)+2 <= data_u-1) and p < pos_limit; advance the
        output index past the emitted outputs.

        Returns (ip int64 array, frac float64 array).  All positions are
        evaluated closed-form from the anchor (see the model above), so
        identical output indices always get bit-identical positions.
        """
        ips, fracs = [], []
        while True:
            p0 = self._pos_at(self._k)
            if math.floor(p0) + 2 > data_u - 1 or p0 >= pos_limit:
                break
            in_slew = self._k < self._slew_n
            # Run length never crosses a rebase boundary, so folds happen
            # at exact k values and chunking cannot shift their rounding.
            n_run = (self._slew_n - self._k) if in_slew \
                else (self._REBASE_K - self._k)
            step_now = self._step_at(self._k)
            step_end = self._step_at(self._k + n_run) if in_slew \
                else self._su_end
            min_step = min(step_now, step_end)
            if min_step <= 0:
                raise RuntimeError("non-positive ratio during slew")
            span = min(float(data_u - 3) - p0, pos_limit - p0)
            n = min(n_run, max(int(span / min_step) + 2, 1))
            kk = self._k + np.arange(n, dtype=np.float64)
            if in_slew:
                pos = (self._anchor + self._su * kk
                       + self._du * (kk * (kk - 1.0) / 2.0))
            else:
                sn = float(self._slew_n)
                ps = (self._anchor + self._su * sn
                      + self._du * (sn * (sn - 1.0) / 2.0))
                pos = ps + self._su_end * (kk - sn)
            ok = ((np.floor(pos).astype(np.int64) + 2 <= data_u - 1)
                  & (pos < pos_limit))
            n_emit = int(ok.sum())       # both conditions fail monotonely
            if n_emit == 0:
                break
            pos = pos[:n_emit]
            ip = np.floor(pos).astype(np.int64)
            ips.append(ip)
            fracs.append(pos - ip)
            self._k += n_emit
            # Deterministic rebase points only: slew completion exactly at
            # k == slew_n, magnitude fold exactly at k == _REBASE_K.
            if self._slew_n and self._k == self._slew_n:
                self._rebase()
            elif self._slew_n == 0 and self._k == self._REBASE_K:
                self._anchor += self._su_end * self._REBASE_K
                self._k = 0
            if n_emit < n:
                break
        if not ips:
            return (np.zeros(0, dtype=np.int64),
                    np.zeros(0, dtype=np.float64))
        return np.concatenate(ips), np.concatenate(fracs)

    # -- processing -------------------------------------------------------

    def _put(self, arr, batch_axis: int):
        """Device placement hook (overridden by the sharded subclass)."""
        return arr

    def _walk_block(self, pos_limit: float):
        """Host walk for one full block; returns (idx, fr, va, n)."""
        nu = self.factor * self.block
        hist_off = self._u_fed - 3       # u index of histbuf[0]
        self._u_fed += nu
        ip, frac = self._walk(self._u_fed, pos_limit)
        n = len(ip)
        if n > self.cap:
            # Cannot happen while io_ratio respects max_ratio; fail
            # loudly rather than silently dropping outputs.
            raise AssertionError(
                f"internal: VR walk emitted {n} > cap {self.cap}")
        idx = np.zeros(self.cap, dtype=np.int32)
        fr = np.zeros(self.cap, dtype=np.float64)
        va = np.zeros(self.cap, dtype=np.float32)
        idx[:n] = (ip - 1) - hist_off    # window = u[ip-1 .. ip+2]
        fr[:n] = frac
        va[:n] = 1.0
        assert n == 0 or (idx[:n].min() >= 0
                          and int(idx[:n].max()) + 4 <= 3 + nu), \
            "internal: VR window outside histbuf"
        return idx, fr, va, n

    def _run_blocks(self, blocks, pos_limit: float, out: str = 'host'):
        """Run K full blocks ([K, S, block]) in one device launch.

        ``out='host'`` downloads each block's valid prefix (sliced on
        device first); ``out='device'`` concatenates the prefixes ON
        DEVICE and returns one jax.Array — every slice bound comes from
        the host-side closed-form walk, so nothing synchronizes.
        """
        k = blocks.shape[0]
        walks = [self._walk_block(pos_limit) for _ in range(k)]
        ns = [w[3] for w in walks]
        # Widest 4-tap window spread within any VR_TILE output tile,
        # bucketed to 128 lanes: the static span of the on-device banded
        # matrices.  Buckets keep recompiles rare (one per ratio regime).
        span = 8
        for idx_w, _f, _v, n in walks:
            for t in range(0, n, VR_TILE):
                hi = idx_w[min(n, t + VR_TILE) - 1]
                span = max(span, int(hi - idx_w[t]) + 4)
        span = -(-span // 128) * 128
        xs = self._put(jnp.asarray(blocks, dtype=self.dtype), 1)
        idx = jnp.asarray(np.stack([w[0] for w in walks]))
        fr = jnp.asarray(np.stack([w[1] for w in walks]), dtype=self.dtype)
        va = jnp.asarray(np.stack([w[2] for w in walks]))
        coeffs = (self._pre_coeffs if self.quality == 'vr-hq'
                  else jnp.zeros((1, 1), dtype=self.dtype))
        self._carry, self._pre_carry, ys = _vr_scan(
            self._carry, self._pre_carry, coeffs, xs, idx, fr, va,
            factor=self.factor, span=span)
        self.samples_out += sum(ns)
        if out == 'device':
            slices = [ys[i, :, :ns[i]] for i in range(k) if ns[i]]
            if not slices:
                return self._put(jnp.zeros((self.batch, 0), self.dtype), 0)
            return jnp.concatenate(slices, axis=1)
        # Slice each block's valid prefix ON DEVICE before transfer: the
        # [K, S, cap] scan output is mostly padding (cap sizes for the
        # max ratio), and downloading it whole would move mostly zeros.
        return np.concatenate(
            [np.asarray(ys[i, :, :ns[i]]) for i in range(k) if ns[i]]
            or [np.zeros((self.batch, 0), self.dtype)], axis=1)

    def process(self, x: np.ndarray) -> np.ndarray:
        """Resample a [batch, n] (or [n] mono) chunk; returns [batch, m].

        The emitted count m varies with the ratio trajectory.  Input is
        accumulated into fixed device blocks, so the emitted stream is
        BIT-EXACT invariant to how the caller chunks the input (the
        device always sees identical block boundaries); all ready blocks
        run in ONE device launch (lax.scan over blocks).
        """
        x = np.asarray(x, dtype=self.dtype)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[0] != self.batch:
            raise ValueError(f"expected batch {self.batch}, got {x.shape[0]}")
        self.samples_in += x.shape[1]
        self._in_fed += x.shape[1]
        self._hold = np.concatenate([self._hold, x], axis=1)
        k = self._hold.shape[1] // self.block
        if k == 0:
            return np.zeros((self.batch, 0), dtype=self.dtype)
        blocks = np.stack(
            [self._hold[:, i * self.block:(i + 1) * self.block]
             for i in range(k)])
        self._hold = self._hold[:, k * self.block:]
        return self._run_blocks(blocks, math.inf)

    def flush(self) -> np.ndarray:
        """Drain outputs whose positions lie inside the real input.

        Canonical contract: every output with (delay-compensated) input
        position p < n_inputs is emitted; the cubic lookahead window is
        satisfied by zero padding (positions beyond the real input are
        blocked by the limit, exactly like the constant-rate flush).
        """
        pos_limit = float(self.factor * self._in_fed + self._delay_u)
        hold = self._hold
        self._hold = np.zeros((self.batch, 0), dtype=self.dtype)
        if self._pos_at(self._k) >= pos_limit:
            return np.zeros((self.batch, 0), dtype=self.dtype)
        # Zero-pad to full blocks until the u-stream covers every
        # emittable position plus the cubic lookahead; the count is
        # exact, not a feed-until-covered loop.
        need_u = max(int(pos_limit) + 3 - self._u_fed, 0)
        k = -(-need_u // (self.factor * self.block))
        k = max(k, 1 if hold.shape[1] else 0)
        if k == 0:
            return np.zeros((self.batch, 0), dtype=self.dtype)
        pad_first = self.block - hold.shape[1]
        first = np.concatenate(
            [hold, np.zeros((self.batch, pad_first), dtype=self.dtype)],
            axis=1)
        blocks = np.concatenate(
            [first[None],
             np.zeros((k - 1, self.batch, self.block), dtype=self.dtype)])
        return self._run_blocks(blocks, pos_limit)

    # -- device-resident serving (zero host syncs) ------------------------

    @property
    def device_chunk_multiple(self) -> int:
        """Input granularity for :meth:`process_device` (the VR block)."""
        return self.block

    def process_device(self, x) -> "jax.Array":
        """Resample a chunk entirely on device; returns a ``jax.Array``.

        The VR twin of EngineCore.process_device: although the output
        count varies with the ratio trajectory, the closed-form anchored
        walk computes every count and slice bound ON HOST — the device
        program only evaluates sample values — so the wrapper never
        synchronizes even mid-slew.  ``x`` is (or is uploaded to) a
        ``[batch, k*block]`` device array; all k blocks run as one
        launch and the valid prefixes are concatenated on device.
        """
        x = jnp.asarray(x, dtype=self.dtype)
        if x.ndim == 1:
            x = (jnp.broadcast_to(x, (self.batch, x.shape[0]))
                 if self.batch > 1 else x[None, :])
        if x.shape[0] != self.batch:
            raise ValueError(f"expected batch {self.batch}, got {x.shape[0]}")
        n = int(x.shape[1])
        if self._hold.shape[1]:
            raise RuntimeError(
                "process_device: host-buffered input pending from a prior "
                "process() call; feed block multiples there, or reset()")
        if n % self.block:
            raise ValueError(
                f"process_device chunk width {n} is not a multiple of "
                f"block={self.block}")
        if n == 0:
            return self._put(jnp.zeros((self.batch, 0), self.dtype), 0)
        self.samples_in += n
        self._in_fed += n
        k = n // self.block
        blocks = jnp.transpose(
            x.reshape(self.batch, k, self.block), (1, 0, 2))
        return self._run_blocks(blocks, math.inf, out='device')

    def flush_device(self) -> "jax.Array":
        """Drain remaining outputs on device (device twin of flush)."""
        pos_limit = float(self.factor * self._in_fed + self._delay_u)
        hold = self._hold
        self._hold = np.zeros((self.batch, 0), dtype=self.dtype)
        empty = self._put(jnp.zeros((self.batch, 0), self.dtype), 0)
        if self._pos_at(self._k) >= pos_limit:
            return empty
        need_u = max(int(pos_limit) + 3 - self._u_fed, 0)
        k = -(-need_u // (self.factor * self.block))
        k = max(k, 1 if hold.shape[1] else 0)
        if k == 0:
            return empty
        pad_first = self.block - hold.shape[1]
        first = np.concatenate(
            [hold, np.zeros((self.batch, pad_first), dtype=self.dtype)],
            axis=1)
        blocks = np.concatenate(
            [first[None],
             np.zeros((k - 1, self.batch, self.block), dtype=self.dtype)])
        return self._run_blocks(blocks, pos_limit, out='device')

    def stream(self, chunks, out: str = 'host'):
        """Pipelined VR streaming (EngineCore.stream twin): dispatch
        chunk k+1 before downloading chunk k, so the device->host
        transfer rides under the next chunk's compute.  Accepts chunks
        of any widths (a host buffer carves block multiples); yields the
        resampled stream ending with the flush tail.  ``out='device'``
        yields ``jax.Array`` without downloading.  Ratio changes via
        :meth:`set_io_ratio` between pulls apply from the next chunk.

        One shared protocol implementation serves both engines
        (streaming.pipelined_stream) — including the ordered yield of
        anything the sub-block remainder emits when host input was
        already buffered before the stream started.
        """
        from .streaming import pipelined_stream

        yield from pipelined_stream(self, chunks, out, self.block)

    # -- introspection ----------------------------------------------------

    def get_statistics(self) -> dict:
        return {"samplesIn": self.samples_in, "samplesOut": self.samples_out,
                "ioRatio": self.get_io_ratio(),
                "slewRemaining": max(self._slew_n - self._k, 0)}
