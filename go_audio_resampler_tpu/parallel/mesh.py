"""Device-mesh scaling for batched stream resampling.

The reference's only parallelism is goroutine-per-channel data parallelism
(constant.go:224-241, SURVEY.md section 2).  The accelerator scaling
model is:

- on one device, channels/streams ride the leading batch axis;
- across devices, that axis is sharded over a 1-D ``jax.sharding.Mesh``
  with ``shard_map`` — pure data parallelism.  No collectives
  are semantically required (streams are independent); optional global
  metrics use ``psum``/``pmax`` reductions.

These helpers are exercised by ``__graft_entry__.dryrun_multichip`` on a
virtual host-platform mesh and by ``chip_smoke.py --cards 4`` on four
GPUs; the mesh is 1-D because every card reaches every other directly.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..engine import plan_engine, EngineCore
from ..ops.precision import dot_precision
from ..engine.variable import VariableRateResampler
from ..engine.oneshot import _oneshot_aux, _oneshot_jit
from ..engine import stages

STREAM_AXIS = "streams"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the stream-batch axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.array(devices), (STREAM_AXIS,))


def sharded_oneshot(plan, x, mesh: Mesh, dtype=jnp.float32):
    """One-shot resample with the stream axis sharded across the mesh.

    ``x`` is [S, n] with S divisible by the mesh size.  Each device runs
    the identical static program on its shard; XLA inserts no collectives
    (streams are independent), so scaling is linear over the mesh's
    devices.  The host-prepared banded matrices (cubic / non-exact-rational
    plans) are passed as replicated device ARGUMENTS, mirroring
    ``oneshot()`` — without them the in-trace fallback bakes ~50 MB of
    matrices per second of audio into the compiled program as constants.
    """
    dtype = jnp.dtype(dtype)
    sharding = NamedSharding(mesh, P(STREAM_AXIS, None))
    replicated = NamedSharding(mesh, P())
    x = jax.device_put(jnp.asarray(x), sharding)
    aux = _oneshot_aux(plan, int(np.shape(x)[1]), dtype)
    aux = tuple(jax.device_put(a, replicated) for a in aux)
    y = _oneshot_jit(plan, x, dtype.name, *aux)
    return y


def sharded_stream_step(plan, mesh: Mesh, batch_per_device: int,
                        block: int, dtype=jnp.float32):
    """Build a sharded streaming step for the two-stage engine.

    Returns (init_state_fn, step_fn, block) — ``block`` is the effective
    per-step input length (rounded up to the fused path's period) — where
    step_fn is jitted under
    ``shard_map`` over the mesh: per-device stream state stays resident in
    device memory, inputs arrive sharded [S_total, block], and a global
    peak statistic is reduced with ``pmax`` across the mesh to exercise a
    collective (the only cross-device traffic; per-sample data never
    crosses devices).

    Exact-rational plans use the fused periodic-matmul step
    (engine/streaming._step_rational_fused): state is just the input carry
    and every step emits a constant sample count; other plans fall back to
    the poly-walk step.  Note the fused step's stream includes the leading
    convolution-ramp outputs ((C/Ipx)*P2 samples) which a consumer trims,
    exactly like EngineCore's drop logic.
    """
    if plan.kind != 'two_stage':
        raise ValueError("sharded_stream_step currently builds the flagship "
                         "two_stage topology")
    if plan.aa_taps and not plan.is_rational_exact:
        raise ValueError("sharded_stream_step does not yet support "
                         "strict-antialias plans with a non-exact walk "
                         "(exact-rational plans fold the aa prefilter "
                         "into the fused matrix)")
    n_dev = mesh.devices.size
    s_total = batch_per_device * n_dev
    sharding = NamedSharding(mesh, P(STREAM_AXIS, None))

    if plan.is_rational_exact:
        from ..engine.oneshot import _fused_rational_matrix, superframe
        r, p2, ipx, lam = _fused_rational_matrix(plan)
        r, ipx = superframe(r, ipx, kf_cap=max(1, block // ipx))
        p2 = r.shape[0]
        wx = r.shape[1]
        block = -(-block // ipx) * ipx
        carry_len = lam + -(-max(wx - ipx - lam, 0) // ipx) * ipx
        rt = jnp.asarray(r.T, dtype=dtype)

        def init_state():
            return jax.device_put(
                jnp.zeros((s_total, carry_len), jnp.dtype(dtype)), sharding)

        @partial(shard_map, mesh=mesh,
                 in_specs=(P(STREAM_AXIS, None), P(STREAM_AXIS, None)),
                 out_specs=(P(STREAM_AXIS, None), P(STREAM_AXIS, None),
                            P(), P()),
                 check_vma=False)
        def _step(carry, x):
            n_frames = x.shape[1] // ipx
            data = jnp.concatenate([carry.astype(x.dtype), x], axis=1)
            starts = jax.lax.iota(jnp.int32, n_frames) * jnp.int32(ipx)
            frames = stages.gather_windows(data, starts, wx)
            y = jnp.einsum('sfw,wp->sfp', frames, rt.astype(x.dtype),
                           preferred_element_type=x.dtype,
                           precision=dot_precision())
            y = y.reshape(x.shape[0], n_frames * p2)
            peak = jax.lax.pmax(jnp.max(jnp.abs(y)), STREAM_AXIS)
            return data[:, x.shape[1]:], y, jnp.int32(n_frames * p2), peak

        return init_state, jax.jit(_step), block

    # General (non-exact-rational) plans: poly-walk step.
    # int32 safety for walk16 (stages.py:40-53): cap < 2^15, the same
    # clamp as EngineCore._build_constants — a large caller block with a
    # high upsampling ratio would otherwise overflow the phase walk.
    m = block * plan.factor
    cap = -(-m * plan.num_phases * 65536 // plan.step) + 1
    while cap > 32767 and block > 1:
        block //= 2
        m = block * plan.factor
        cap = -(-m * plan.num_phases * 65536 // plan.step) + 1
    step_in = -(-plan.step // (plan.num_phases * 65536))
    keep = plan.poly_taps + step_in + 2
    hist_size = keep + m + plan.lengths.core_delta()

    pre_coeffs = jnp.asarray(plan.pre_coeffs, dtype=dtype)
    banks = tuple(jnp.asarray(b, dtype=dtype) for b in
                  (plan.bank_a, plan.bank_b, plan.bank_c, plan.bank_d))

    def init_state():
        d = jnp.dtype(dtype)
        rep = NamedSharding(mesh, P())
        pre = stages.PrestageState(carry=jax.device_put(
            jnp.zeros((s_total, plan.pre_taps - 1), d), sharding))
        poly = stages.PolyState(
            hist=jax.device_put(jnp.zeros((s_total, hist_size), d), sharding),
            hist_len=jax.device_put(jnp.zeros((), jnp.int32), rep),
            at_hi=jax.device_put(
                jnp.full((), plan.at0 >> 16, jnp.int32), rep),
            at_lo=jax.device_put(
                jnp.full((), plan.at0 & 0xFFFF, jnp.int32), rep))
        return pre, poly

    @partial(shard_map, mesh=mesh,
             in_specs=((P(STREAM_AXIS, None),
                        (P(STREAM_AXIS, None), P(), P(), P())),
                       P(STREAM_AXIS, None)),
             out_specs=((P(STREAM_AXIS, None),
                         (P(STREAM_AXIS, None), P(), P(), P())),
                        P(STREAM_AXIS, None), P(), P()),
             check_vma=False)
    def _step(state, x):
        pre_state, poly_tuple = state
        poly_state = stages.PolyState(*poly_tuple)
        pre_state, u = stages.prestage_process(pre_coeffs, pre_state, x,
                                               plan.factor)
        poly_state, y, valid, n = stages.poly_process(
            banks, poly_state, u, plan.num_phases, plan.poly_taps,
            plan.step_hi, plan.step_lo, cap)
        # Cross-device reduction (the only collective): global output peak.
        peak = jax.lax.pmax(jnp.max(jnp.abs(y)), STREAM_AXIS)
        new_state = (pre_state, (poly_state.hist, poly_state.hist_len,
                                 poly_state.at_hi, poly_state.at_lo))
        return new_state, y, n, peak

    @jax.jit
    def step_fn(state, x):
        pre_state, poly_state = state
        packed = (pre_state, (poly_state.hist, poly_state.hist_len,
                              poly_state.at_hi, poly_state.at_lo))
        new_packed, y, n, peak = _step(packed, x)
        new_pre, poly_tuple = new_packed
        return (new_pre, stages.PolyState(*poly_tuple)), y, n, peak

    return init_state, step_fn, block


class ShardedEngineCore(EngineCore):
    """EngineCore whose device step runs under ``shard_map`` over a mesh.

    Full streaming semantics — all four topologies, strict-antialias
    prefilter, transient drop, canonical trim and flush — with the stream
    batch sharded across devices.  The per-device program is identical to
    the single-chip step (pure data parallelism; no collectives), so the
    emitted sample stream is bit-identical to a serial EngineCore with the
    same plan/block/dtype.

    ``batch_per_device`` streams live on each of the mesh's devices; the
    total batch is ``batch_per_device * mesh.size``.
    """

    def __init__(self, plan, mesh: Mesh, batch_per_device: int = 1,
                 block: int = 2048, dtype=jnp.float32,
                 precision: str = 'auto'):
        self.mesh = mesh
        super().__init__(plan, batch=batch_per_device * mesh.devices.size,
                         block=block, dtype=dtype, precision=precision)

    def _spec_of(self, tree):
        return jax.tree_util.tree_map(
            lambda leaf: P(STREAM_AXIS, None)
            if jnp.asarray(leaf).ndim >= 2 else P(), tree)

    def _init_state(self):
        state = super()._init_state()
        shard = NamedSharding(self.mesh, P(STREAM_AXIS, None))
        rep = NamedSharding(self.mesh, P())

        def place(leaf):
            leaf = jnp.asarray(leaf)
            return jax.device_put(leaf, shard if leaf.ndim >= 2 else rep)
        return jax.tree_util.tree_map(place, state)

    def reset(self):
        super().reset()
        if self._has_aa:
            # the FIR carry rides GSPMD sharding (no shard_map needed for
            # a pure batch-parallel convolution)
            self._aa_carry = jax.device_put(
                self._aa_carry,
                NamedSharding(self.mesh, P(STREAM_AXIS, None)))

    def _put_batch(self, arr):
        # Device-mode head intermediates shard on the stream axis so the
        # head-corrected output keeps the step output's sharding.
        return jax.device_put(
            arr, NamedSharding(self.mesh, P(STREAM_AXIS, None)))

    def _make_step(self):
        inner = self.core_fn()
        state_spec = self._spec_of(super()._init_state())
        fn = shard_map(inner, mesh=self.mesh,
                       in_specs=(state_spec, P(STREAM_AXIS, None)),
                       out_specs=(state_spec, P(STREAM_AXIS, None), P()),
                       check_vma=False)
        return jax.jit(fn, donate_argnums=0)

    def _make_scan(self):
        multi = self._scan_core()
        state_spec = self._spec_of(
            EngineCore._init_state(self))
        fn = shard_map(multi, mesh=self.mesh,
                       in_specs=(state_spec, P(STREAM_AXIS, None, None)),
                       out_specs=(state_spec, P(None, STREAM_AXIS, None),
                                  P(None)),
                       check_vma=False)
        return jax.jit(fn, donate_argnums=0)


def global_stream_stats(x, mesh: Mesh):
    """Global RMS/peak over a sharded stream batch via psum/pmax."""
    sharding = NamedSharding(mesh, P(STREAM_AXIS, None))
    x = jax.device_put(jnp.asarray(x), sharding)

    @partial(shard_map, mesh=mesh, in_specs=P(STREAM_AXIS, None),
             out_specs=(P(), P()), check_vma=False)
    def stats(shard):
        ss = jax.lax.psum(jnp.sum(shard * shard), STREAM_AXIS)
        n = jax.lax.psum(jnp.asarray(shard.size, jnp.float32), STREAM_AXIS)
        peak = jax.lax.pmax(jnp.max(jnp.abs(shard)), STREAM_AXIS)
        return jnp.sqrt(ss / n), peak

    return stats(x)


class ShardedVariableRateResampler(VariableRateResampler):
    """Variable-rate engine with the batch axis sharded across a mesh.

    The VR device step (engine/variable.py) is embarrassingly parallel
    over streams: the per-output index/fraction arrays are replicated
    (identical walk for every stream) while the carry and input blocks
    shard on the batch axis — pure stream data parallelism, the same model as
    ShardedEngineCore.  The host-side position walk is unchanged.
    """

    def __init__(self, max_ratio: float, io_ratio: float = 1.0, *,
                 mesh: Mesh, batch_per_device: int = 1, **kwargs):
        self.mesh = mesh
        self._sharding = NamedSharding(mesh, P(STREAM_AXIS, None))
        super().__init__(max_ratio, io_ratio,
                         batch=batch_per_device * mesh.size, **kwargs)

    def reset(self) -> None:
        super().reset()
        self._carry = jax.device_put(self._carry, self._sharding)
        self._pre_carry = jax.device_put(self._pre_carry, self._sharding)

    def _put(self, arr, batch_axis: int):
        spec = [None] * arr.ndim
        spec[batch_axis] = STREAM_AXIS
        return jax.device_put(arr, NamedSharding(self.mesh, P(*spec)))
