"""Batched 1-D FIR convolution with backend-aware lowering.

This is the framework's replacement for the reference's SIMD kernels
``ConvolveValid`` / ``ConvolveValidMulti`` (simdops/ops.go:26-50): a single
primitive ``conv1d_poly(x, kernels, stride)`` computing

    y[s, f, i] = sum_t x[s, i*stride + t] * kernels[f, t]

Three lowerings:

- ``xla``:    ``lax.conv_general_dilated`` — the textbook form.
- ``frames``: tiled windows-gather + einsum.  Used on CPU where
              XLA:CPU's conv compilation is pathologically slow for long
              audio kernels (50+ s per shape).
- ``banded``: grouped-frames banded matmul — P outputs per frame read a
              shared (P-1)*stride+T window against a banded [W, P*F]
              matrix (the same structure as the engine's fused rational/
              decimation paths).  Read amplification 1 + T/(P*stride)
              instead of T; one big matmul.  Accelerator default.

The default picks per backend at trace time (ops/lowering.py);
``set_conv_impl`` overrides.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .lowering import conv_impl
from .precision import dot_precision

_IMPL_OVERRIDE: str | None = None


def set_conv_impl(impl: str | None) -> None:
    """Force a lowering: 'xla', 'frames', 'banded', or None (default)."""
    global _IMPL_OVERRIDE
    if impl not in (None, 'xla', 'frames', 'banded'):
        raise ValueError(f"unknown conv impl: {impl}")
    _IMPL_OVERRIDE = impl


def _impl() -> str:
    if _IMPL_OVERRIDE is not None:
        return _IMPL_OVERRIDE
    return conv_impl()


def _conv_xla(x: jax.Array, kernels: jax.Array, stride: int,
              precision: str = 'auto') -> jax.Array:
    return lax.conv_general_dilated(
        x[:, None, :], kernels[:, None, :].astype(x.dtype),
        window_strides=(stride,), padding='VALID',
        dimension_numbers=('NCH', 'OIH', 'NCH'),
        preferred_element_type=x.dtype,
        precision=dot_precision(precision))


def _conv_frames(x: jax.Array, kernels: jax.Array, stride: int,
                 tile: int = 512, precision: str = 'auto') -> jax.Array:
    n = x.shape[1]
    f, t = kernels.shape
    n_out = (n - t) // stride + 1
    k = kernels.astype(x.dtype)
    if n_out <= tile:
        starts = lax.iota(jnp.int32, n_out) * stride
        idx = jnp.clip(starts[:, None] + lax.iota(jnp.int32, t)[None, :],
                       0, n - 1)
        w = jnp.take(x, idx, axis=1)                     # [S, n_out, T]
        return jnp.einsum('sct,ft->sfc', w, k,
                          preferred_element_type=x.dtype,
                          precision=dot_precision(precision))
    padded = -(-n_out // tile) * tile
    starts = lax.iota(jnp.int32, padded) * stride
    idx = jnp.clip(starts[:, None] + lax.iota(jnp.int32, t)[None, :], 0, n - 1)
    idx_r = idx.reshape(-1, tile, t)

    def tile_fn(ix):
        w = jnp.take(x, ix, axis=1)                      # [S, tile, T]
        return jnp.einsum('sct,ft->sfc', w, k,
                          preferred_element_type=x.dtype,
                          precision=dot_precision(precision))

    y = lax.map(tile_fn, idx_r)                          # [ntiles, S, F, tile]
    y = jnp.moveaxis(y, 0, 2).reshape(x.shape[0], f, padded)
    return y[:, :, :n_out]


def _conv_banded(x: jax.Array, kernels: jax.Array, stride: int,
                 period: int = 256, interleaved: bool = False,
                 precision: str = 'auto') -> jax.Array:
    """Grouped banded-matmul lowering (see module docstring).

    With ``interleaved`` the result is the flat [S, n_out*F] stream
    y[s, i*F + ff] (the polyphase-upsampling order) — the band's natural
    output layout, skipping two whole-array transposes.
    """
    import numpy as np

    n = x.shape[1]
    f, t = kernels.shape
    n_out = (n - t) // stride + 1

    def band_matrix(p):
        w = (p - 1) * stride + t
        # R[ii*stride + tau, ii*f + ff] = kernels[ff, tau], built on
        # device from host-constant index arrays (kernels may be traced).
        ii = np.repeat(np.arange(p), f * t)
        ff = np.tile(np.repeat(np.arange(f), t), p)
        tau = np.tile(np.arange(t), p * f)
        vals = kernels.astype(x.dtype)[jnp.asarray(ff), jnp.asarray(tau)]
        return jnp.zeros((w, p * f), x.dtype).at[
            jnp.asarray(ii * stride + tau),
            jnp.asarray(ii * f + ff)].set(vals), w

    p = min(period, max(n_out, 1))
    nf = -(-n_out // p)
    r, w = band_matrix(p)
    need = (nf - 1) * p * stride + w
    if n < need:
        x = jnp.pad(x, ((0, 0), (0, need - n)))
    frames = jnp.take(x, jnp.asarray(
        np.arange(nf, dtype=np.int64)[:, None] * p * stride
        + np.arange(w)[None, :], dtype=jnp.int32), axis=1)  # [S,nf,W]
    y3 = jnp.einsum('snw,wk->snk', frames, r,
                    preferred_element_type=x.dtype,
                    precision=dot_precision(precision))  # [S, nf, P*F]
    if interleaved:
        # y3[s, n, ii*f + ff] = filter ff at output n*p + ii — already
        # the polyphase-interleaved stream order; flatten for free.
        return y3.reshape(x.shape[0], nf * p * f)[:, :n_out * f]
    y = y3.reshape(x.shape[0], nf, p, f)
    y = jnp.transpose(y, (0, 3, 1, 2)).reshape(x.shape[0], f, nf * p)
    return y[:, :, :n_out]


def conv1d_poly(x: jax.Array, kernels: jax.Array, stride: int = 1,
                precision: str = 'auto') -> jax.Array:
    """y[s, f, i] = sum_t x[s, i*stride + t] * kernels[f, t]  ('VALID').

    ``kernels`` rows are tap-reversed filters (design-time convention), so
    this correlation implements the reference's convolution direction.
    ``precision`` is the per-call matmul-tier pin ('auto' = the
    process-global GAR_TPU_MATMUL_PRECISION).
    """
    impl = _impl()
    if impl == 'xla':
        return _conv_xla(x, kernels, stride, precision)
    if impl == 'banded':
        return _conv_banded(x, kernels, stride, precision=precision)
    return _conv_frames(x, kernels, stride, precision=precision)


def conv1d_poly_interleaved(x: jax.Array, kernels: jax.Array,
                            precision: str = 'auto') -> jax.Array:
    """u[s, i*F + ff] = sum_t x[s, i + t] * kernels[ff, t] (stride 1).

    The polyphase-upsampled stream in its natural interleaved order.
    The banded lowering emits this layout directly (no transposes); the
    other lowerings transpose the [S, F, n_out] conv output.
    """
    if _impl() == 'banded':
        return _conv_banded(x, kernels, 1, interleaved=True,
                            precision=precision)
    out = conv1d_poly(x, kernels, 1, precision)   # [S, F, n_out]
    f = kernels.shape[0]
    return jnp.transpose(out, (0, 2, 1)).reshape(
        x.shape[0], out.shape[2] * f)
