"""Pure-functional resampling: a traceable, differentiable JAX op.

The reference is a stateful host library; its one-shot helpers
(convenience.go:204-229) run outside any compiler.  On an accelerator the
natural extra surface — one the reference cannot offer — is resampling as a
*JAX op*: a pure function of a device array that users drop inside
their own ``jit`` / ``vmap`` / ``grad`` / ``shard_map`` programs (e.g.
48k->16k ingest or augmentation inside a training step, with gradients
flowing through to a learned front end).

Semantics match the one-shot stream (``engine.oneshot``): for ``n``
input samples the output is the canonical ``ceil(n * ratio)`` samples
of the fully flushed stream, identical to
``convenience.resample_mono`` bit-for-bit.

Differentiation: resampling is a linear operator ``y = R x``, so the
VJP is the transposed operator ``x_bar = R^T y_bar``.  Every lowering is
plain gather/matmul/scan, whose primitives have transpose rules, so JAX
differentiates the forward program directly; both directions use the
same coefficients, so gradient checks hold to machine precision.

Shapes are static under tracing, as everywhere in JAX: one compiled
program per (rates, quality, n, dtype).  Program size stays compact at
ANY length: exact-rational configs lower through the per-period fused
matrix (a small plan-dependent constant), and non-exact ratios / QUICK
cubic lower through a ``lax.scan`` of the streaming step kernels whose
only constants are the coefficient banks — NOT through the one-shot
banded tile matrices, which scale with the audio length and would be
baked into the USER'S traced program as constants (tens of MB per
minute of audio).
The scan path equals the one-shot stream to float rounding (the tile
matmul sums in a different order); exact-rational configs remain
bit-identical to ``convenience.resample_mono``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .api import QualityPreset
from .convenience import preset_to_engine_quality
from .engine import plan_engine, stages
from .engine.oneshot import _oneshot_jit
from .engine.plan import EnginePlan
from .engine.stages import (CubicState, PolyState, PrestageState, I32)

# The undecorated traceable body of the one-shot program: tracing happens
# in the *caller's* context (the user's jit/grad/shard_map trace).
_core = _oneshot_jit.__wrapped__


def _needs_length_matrices(plan: EnginePlan) -> bool:
    """Plans whose one-shot lowering builds per-length banded matrices."""
    return (plan.kind == 'cubic'
            or (plan.kind == 'two_stage' and not plan.is_rational_exact))


def _scan_apply(plan: EnginePlan, x: jax.Array, dtype) -> jax.Array:
    """Canonical one-shot stream via a scan of the streaming step.

    The functional path for non-exact-rational / cubic plans: the whole
    input (plus the exact flush padding and the holdback slack) streams
    through the per-block step kernel under ``lax.scan``; every block's
    valid outputs are scattered to their stream offsets on device.  All
    constants are the compact coefficient banks — program size is
    independent of the audio length.  Per-block valid counts are traced
    int32 (they depend only on the deterministic walk, but computing
    them host-side would bake per-length index constants, defeating the
    point), so the assembly is one masked scatter-add into the bound
    ``drop + canonical`` with a dump slot for masked lanes.
    """
    s, n = x.shape
    lm = plan.lengths
    canonical = lm.canonical(n)
    if canonical <= 0 or n == 0:
        return jnp.zeros((s, max(canonical, 0)), dtype)
    x = x.astype(dtype)
    drop = lm.drop_prefix()
    z = lm.flush_pad(n)

    if plan.kind == 'cubic':
        block = 4096
        cap = -(-(block << 32) // plan.cubic_step) + 1
        while cap > 32767 and block > 1:      # walk32 int32 bound
            block //= 2
            cap = -(-(block << 32) // plan.cubic_step) + 1
        hold = 4
        state0 = CubicState(carry=jnp.zeros((s, 3), dtype),
                            at_int=I32(0), at_f1=I32(0), at_f0=I32(0))

        def step(st, xb):
            st, y, valid, n_ = stages.cubic_process(
                st, xb, plan.cubic_step, cap)
            return st, (y, n_)
    else:
        block = 4096
        m = block * plan.factor
        cap = -(-(m * plan.num_phases * 65536) // plan.step) + 1
        while cap > 32767 and block > 1:      # walk16 int32 bound
            block //= 2
            m = block * plan.factor
            cap = -(-(m * plan.num_phases * 65536) // plan.step) + 1
        if cap > 32767:
            # Unreachable for ratios within MAX_RATIO (cap ~ block*ratio),
            # but block==1 would otherwise divide by zero below.
            raise ValueError(
                f"polyphase walk cap {cap} exceeds the int32 bound even at "
                f"block=1 (ratio {plan.ratio}); ratio out of supported range")
        step_in = -(-plan.step // (plan.num_phases * 65536))
        hist = plan.poly_taps + step_in + 2 + m + lm.core_delta()
        hold = hist
        banks = tuple(jnp.asarray(b, dtype) for b in
                      (plan.bank_a, plan.bank_b, plan.bank_c, plan.bank_d))
        pre_coeffs = jnp.asarray(plan.pre_coeffs, dtype)
        state0 = (PrestageState(
            carry=jnp.zeros((s, plan.pre_taps - 1), dtype)),
            PolyState(hist=jnp.zeros((s, hist), dtype), hist_len=I32(0),
                      at_hi=I32(plan.at0 >> 16),
                      at_lo=I32(plan.at0 & 0xFFFF)))

        def step(st, xb):
            pre, poly = st
            pre, u = stages.prestage_process(pre_coeffs, pre, xb,
                                             plan.factor)
            poly, y, valid, n_ = stages.poly_process(
                banks, poly, u, plan.num_phases, plan.poly_taps,
                plan.step_hi, plan.step_lo, cap)
            return (pre, poly), (y, n_)

    total_in = n + z + hold
    k = -(-total_in // block)
    xs = jnp.pad(x, ((0, 0), (0, k * block - n)))
    xs = jnp.swapaxes(xs.reshape(s, k, block), 0, 1)     # [K, S, B]
    _, (ys, ns) = lax.scan(step, state0, xs)             # [K, S, cap], [K]
    # Stream offsets of each block's first ns[k] columns; everything
    # masked or past the canonical bound lands in the dump slot.
    cum = jnp.cumsum(ns) - ns                            # exclusive prefix
    bound = drop + canonical
    j = lax.iota(I32, cap)[None, :]                      # [1, cap]
    idx = cum[:, None] + j                               # [K, cap]
    keep = (j < ns[:, None]) & (idx < bound)
    idx = jnp.where(keep, idx, bound)
    ys_f = jnp.swapaxes(ys, 0, 1).reshape(s, k * cap)
    out = jnp.zeros((s, bound + 1), dtype)
    out = out.at[:, idx.reshape(-1)].add(ys_f)
    return out[:, drop:drop + canonical]


def _apply(plan: EnginePlan, x2: jax.Array, dtype_name: str) -> jax.Array:
    if _needs_length_matrices(plan):
        return _scan_apply(plan, x2, jnp.dtype(dtype_name))
    return _core(plan, x2, dtype_name)


def output_length(n: int, input_rate: float, output_rate: float,
                  quality: QualityPreset = QualityPreset.HIGH,
                  hq_interp: bool = False) -> int:
    """Canonical output length of ``resample`` for ``n`` input samples."""
    plan = _plan(float(input_rate), float(output_rate), quality, hq_interp)
    return max(plan.lengths.canonical(int(n)), 0)


@functools.lru_cache(maxsize=None)
def _plan(input_rate: float, output_rate: float,
          quality: QualityPreset, hq_interp: bool = False) -> EnginePlan:
    return plan_engine(input_rate, output_rate,
                       preset_to_engine_quality(quality),
                       hq_interp=hq_interp)


def resample(x, input_rate: float, output_rate: float, *,
             quality: QualityPreset = QualityPreset.HIGH,
             dtype=None, hq_interp: bool = False) -> jax.Array:
    """Resample the last axis of ``x`` — pure, jittable, differentiable.

    Args:
      x: ``[..., n]`` array (any leading batch axes; they are flattened
        into the stream axis for the kernel and restored on output).
      input_rate / output_rate: sample rates (static Python floats).
      quality: a :class:`QualityPreset` (static).
      dtype: compute dtype; defaults to ``x.dtype`` for float inputs,
        else float32.
      hq_interp: (beyond reference, static) corrected phase-bank
        boundary + 8x denser banks for non-exact ratios; see
        api.Config.hq_interp.  Same device shapes, so gradients and
        shard_map behavior are unchanged.

    Returns:
      ``[..., m]`` with ``m = output_length(n, ...)`` — the canonical
      fully-flushed one-shot stream, equal to
      ``convenience.resample_mono`` per leading index.
    """
    plan = _plan(float(input_rate), float(output_rate), quality, hq_interp)
    x = jnp.asarray(x)
    if x.ndim == 0:
        raise ValueError("resample expects at least one axis of samples")
    if dtype is None:
        dtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) \
            else jnp.float32
    dtype = jnp.dtype(dtype)
    lead = x.shape[:-1]
    n = x.shape[-1]
    x2 = x.reshape((int(np.prod(lead, dtype=np.int64)) if lead else 1, n))
    y2 = _apply(plan, x2, dtype.name)
    return y2.reshape(lead + (y2.shape[-1],))
