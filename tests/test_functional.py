"""Functional (traceable) resample op: jit / vmap / grad / shard_map.

This surface has no reference counterpart (the Go library is host-only;
convenience.go:204-229 is the closest analog) — it is the accelerator-native
"resample as a layer" capability.  The contract under test:

- bit parity with ``convenience.resample_mono`` (same one-shot stream),
- composability: works inside a user's ``jax.jit`` program and under
  ``jax.vmap`` over leading axes,
- exact differentiation: the custom VJP is the transposed linear
  operator, so the adjoint identity <Rx, y> == <x, R^T y> holds to
  machine precision and ``jax.grad`` matches finite differences,
- sharding: runs under ``shard_map`` over the stream axis.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import go_audio_resampler_tpu as gar
from go_audio_resampler_tpu import functional

RNG = np.random.default_rng(0xF0)

CASES = [
    (44100.0, 48000.0, gar.QualityPreset.HIGH),      # fused rational
    (48000.0, 44100.0, gar.QualityPreset.VERY_HIGH),
    (96000.0, 48000.0, gar.QualityPreset.HIGH),      # integer decimation
    (48000.0, 96000.0, gar.QualityPreset.MEDIUM),    # dft_up
    (44100.0, 48000.0, gar.QualityPreset.QUICK),     # cubic
    (44100.0, 48001.0, gar.QualityPreset.HIGH),      # non-exact-rational
]


class TestParity:
    @pytest.mark.parametrize("inr,outr,q", CASES)
    def test_matches_resample_mono(self, inr, outr, q):
        x = RNG.normal(size=3000) * 0.5
        y = np.asarray(gar.resample(x, inr, outr, quality=q,
                                    dtype=jnp.float64))
        ref = gar.resample_mono(x, inr, outr, quality=q)
        assert y.shape == ref.shape
        np.testing.assert_allclose(y, ref, rtol=1e-12, atol=1e-12)

    def test_output_length_helper(self):
        for inr, outr, q in CASES:
            n = 2111
            m = functional.output_length(n, inr, outr, q)
            y = gar.resample(RNG.normal(size=n), inr, outr, quality=q)
            assert y.shape == (m,)

    def test_leading_axes_restored(self):
        x = RNG.normal(size=(2, 3, 1000)).astype(np.float32)
        y = gar.resample(x, 48000, 44100)
        m = functional.output_length(1000, 48000, 44100)
        assert y.shape == (2, 3, m)
        # each leading index equals its own mono resample
        one = gar.resample(x[1, 2], 48000, 44100)
        np.testing.assert_allclose(np.asarray(y[1, 2]), np.asarray(one),
                                   rtol=1e-6, atol=1e-7)


class TestComposability:
    def test_inside_user_jit(self):
        x = jnp.asarray(RNG.normal(size=(4, 2000)).astype(np.float32))

        @jax.jit
        def pipeline(x):
            y = gar.resample(x, 48000, 16000,
                             quality=gar.QualityPreset.HIGH)
            return jnp.tanh(y) * 2.0

        out = pipeline(x)
        m = functional.output_length(2000, 48000, 16000)
        assert out.shape == (4, m)
        direct = gar.resample(x, 48000, 16000,
                              quality=gar.QualityPreset.HIGH)
        np.testing.assert_allclose(np.asarray(out),
                                   np.tanh(np.asarray(direct)) * 2.0,
                                   rtol=1e-6, atol=1e-6)

    def test_vmap(self):
        x = jnp.asarray(RNG.normal(size=(5, 1500)).astype(np.float32))
        f = lambda v: gar.resample(v, 44100, 48000)
        y_vmap = jax.vmap(f)(x)
        y_batch = gar.resample(x, 44100, 48000)
        np.testing.assert_allclose(np.asarray(y_vmap),
                                   np.asarray(y_batch),
                                   rtol=1e-6, atol=1e-7)

    def test_shard_map_over_streams(self):
        from jax import shard_map
        from jax.sharding import Mesh, PartitionSpec as P

        devs = jax.devices()
        if len(devs) < 2:
            pytest.skip("needs a multi-device mesh")
        mesh = Mesh(np.array(devs[:2]), ("s",))
        x = jnp.asarray(RNG.normal(size=(8, 1000)).astype(np.float32))

        f = shard_map(lambda v: gar.resample(v, 44100, 48000),
                      mesh=mesh, in_specs=P("s", None),
                      out_specs=P("s", None))
        y = f(x)
        ref = gar.resample(x, 44100, 48000)
        # per-shard shapes compile to different (equally valid) f32
        # contraction orders than the full batch; bound the drift at the
        # f32 rounding scale rather than requiring bit identity
        np.testing.assert_allclose(np.asarray(y), np.asarray(ref),
                                   rtol=1e-4, atol=2e-6)

    def test_grad_through_shard_map(self):
        """Gradients through the sharded op: the custom VJP must carry
        the cotangent's varying-manual-axes type (vma) or shard_map's
        pullback rejects it."""
        from jax import shard_map
        from jax.sharding import Mesh, PartitionSpec as P

        devs = jax.devices()
        if len(devs) < 2:
            pytest.skip("needs a multi-device mesh")
        mesh = Mesh(np.array(devs[:2]), ("s",))
        x = jnp.asarray(RNG.normal(size=(4, 800)).astype(np.float32))

        f = shard_map(lambda v: gar.resample(v, 48000, 16000),
                      mesh=mesh, in_specs=P("s", None),
                      out_specs=P("s", None))
        g_sharded = jax.grad(lambda v: jnp.sum(f(v) ** 2))(x)
        g_serial = jax.grad(
            lambda v: jnp.sum(gar.resample(v, 48000, 16000) ** 2))(x)
        assert g_sharded.shape == x.shape
        np.testing.assert_allclose(np.asarray(g_sharded),
                                   np.asarray(g_serial),
                                   rtol=1e-4, atol=3e-5)


class TestDifferentiation:
    @pytest.mark.parametrize("inr,outr,q", [
        (44100.0, 48000.0, gar.QualityPreset.HIGH),
        (96000.0, 48000.0, gar.QualityPreset.HIGH),
        (44100.0, 48000.0, gar.QualityPreset.QUICK),
        (44100.0, 48001.0, gar.QualityPreset.MEDIUM),
    ])
    def test_adjoint_identity(self, inr, outr, q):
        n = 700
        m = functional.output_length(n, inr, outr, q)
        x = jnp.asarray(RNG.normal(size=(1, n)))
        y = jnp.asarray(RNG.normal(size=(1, m)))
        f = lambda v: gar.resample(v, inr, outr, quality=q,
                                   dtype=jnp.float64)
        rx, vjp = jax.vjp(f, x)
        (xbar,) = vjp(y)
        lhs = float(jnp.vdot(rx, y))
        rhs = float(jnp.vdot(x, xbar))
        assert abs(lhs - rhs) < 1e-9 * max(1.0, abs(lhs)), (lhs, rhs)

    def test_grad_matches_finite_difference(self):
        n = 400
        x = jnp.asarray(RNG.normal(size=n))
        w = jnp.asarray(RNG.normal(
            size=functional.output_length(n, 44100, 48000)))

        def loss(v):
            y = gar.resample(v, 44100, 48000, dtype=jnp.float64)
            return jnp.sum(y * w)

        g = jax.grad(loss)(x)
        # linear op: directional derivative is exact; compare against a
        # central difference along a random direction
        d = jnp.asarray(RNG.normal(size=n))
        eps = 1e-3
        fd = (loss(x + eps * d) - loss(x - eps * d)) / (2 * eps)
        assert abs(float(jnp.vdot(g, d)) - float(fd)) < 1e-6 * max(
            1.0, abs(float(fd)))

    def test_grad_inside_jit_training_step(self):
        """The advertised use: gradients through ingest resampling."""
        n = 600
        m = functional.output_length(n, 48000, 16000)
        w = jnp.asarray(RNG.normal(size=m).astype(np.float32))
        x = jnp.asarray(RNG.normal(size=(2, n)).astype(np.float32))

        @jax.jit
        def step(x):
            def loss(v):
                y = gar.resample(v, 48000, 16000)
                return jnp.mean((y * w) ** 2)
            return jax.value_and_grad(loss)(x)

        val, g = step(x)
        assert np.isfinite(float(val))
        assert g.shape == x.shape
        assert np.isfinite(np.asarray(g)).all()
        assert float(jnp.abs(g).max()) > 0


class TestProgramSize:
    """The functional op must stay compact at ANY audio length inside a
    USER's jit: the one-shot tile matrices scale with length and would be
    baked into the user's program as constants (tens of MB per minute ->
    remote-compile payload failures); the scan lowering's constants are
    the coefficient banks only."""

    @pytest.mark.parametrize("inr,outr,q", [
        (44100.0, 48001.0, gar.QualityPreset.HIGH),   # non-exact rational
        (44100.0, 48000.0, gar.QualityPreset.QUICK),  # cubic
    ])
    def test_minute_of_audio_traces_small(self, inr, outr, q):
        n = 60 * 44100
        x = jax.ShapeDtypeStruct((1, n), jnp.float32)
        f = jax.jit(lambda v: gar.resample(v, inr, outr, quality=q))
        txt = f.lower(x).as_text()
        # Coefficient banks + program text; the old lowering exceeded
        # this by two orders of magnitude (per-length tile matrices).
        assert len(txt) < 3_000_000, f"{len(txt)} bytes of HLO"

    def test_adjoint_still_exact_on_scan_path(self):
        inr, outr, q = 44100.0, 48001.0, gar.QualityPreset.HIGH
        n = 5000
        m = functional.output_length(n, inr, outr, q)
        x = jnp.asarray(RNG.normal(size=(2, n)))
        y = jnp.asarray(RNG.normal(size=(2, m)))
        f = lambda v: gar.resample(v, inr, outr, quality=q,
                                   dtype=jnp.float64)
        rx, vjp = jax.vjp(f, x)
        (xbar,) = vjp(y)
        lhs = float(jnp.vdot(rx, y))
        rhs = float(jnp.vdot(x, xbar))
        assert abs(lhs - rhs) < 1e-9 * max(1.0, abs(lhs)), (lhs, rhs)
