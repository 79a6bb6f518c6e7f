"""Time-major serving engine (engine/tmajor.py).

Transpose equivalence with the stream-major EngineCore is the contract:
same canonical grid, same counts, same values up to matmul summation
order.  The time-major lowering gathers row windows [F, Wx, S] and runs
one einsum with no transpose; it is checked against a dense float64
reference and against EngineCore's output.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from go_audio_resampler_tpu.engine import (EngineCore, TimeMajorEngine,
                                           plan_engine)
from go_audio_resampler_tpu.engine.tmajor import (_step_banded_tmajor,
                                                  _tmajor_frames_apply)
from go_audio_resampler_tpu.filterdesign import Quality

RNG = np.random.default_rng(3)


class TestTmajorLowering:
    # Stream counts: 1 (mono), 3 (not a power of two) and 256 (a serving
    # batch); frame counts 1 and 12.
    @pytest.mark.parametrize("s", [1, 3, 256])
    @pytest.mark.parametrize("n_frames", [1, 12])
    def test_matches_dense(self, s, n_frames):
        ipx, wx, p2 = 147, 343, 160
        n = (n_frames - 1) * ipx + wx
        xt = RNG.normal(size=(n, s)).astype(np.float32)
        r = RNG.normal(size=(p2, wx)).astype(np.float32)
        y = np.asarray(_tmajor_frames_apply(
            jnp.asarray(xt), jnp.asarray(r), ipx, wx, p2, n_frames))
        ref = np.concatenate(
            [r.astype(np.float64) @ xt[m * ipx:m * ipx + wx]
             for m in range(n_frames)])
        assert y.shape == ref.shape == (n_frames * p2, s)
        np.testing.assert_allclose(y, ref, atol=2e-4)

    def test_precision_pin_reaches_trace(self):
        """The per-engine tier pins the time-major dot_general too."""
        data = jnp.zeros((343 + 147, 4), jnp.float32)
        r = jnp.zeros((160, 343), jnp.float32)

        def trace(tier):
            return str(jax.make_jaxpr(lambda d: _tmajor_frames_apply(
                d, r, 147, 343, 160, 2, tier))(data))
        assert "HIGHEST" in trace("highest")
        assert "HIGHEST" not in trace("high") and "HIGH" in trace("high")

    def test_float32_matches_enginecore(self):
        """f32 time-major stream equals EngineCore's, transposed."""
        plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
        s = 4
        ref_eng = EngineCore(plan, batch=s, block=2048, dtype=jnp.float32)
        mult = ref_eng.device_chunk_multiple
        x = (RNG.normal(size=(s, 12 * mult)) * 0.5).astype(np.float32)
        y_ref = np.concatenate(
            [np.asarray(ref_eng.process_device(jnp.asarray(x))),
             np.asarray(ref_eng.flush_device())], axis=1)
        tm = TimeMajorEngine(plan, batch=s, block=2048, dtype=jnp.float32)
        y_tm = np.concatenate(
            [np.asarray(tm.process_device(jnp.asarray(x.T))),
             np.asarray(tm.flush_device())], axis=0)
        assert y_tm.shape == (y_ref.shape[1], s)
        np.testing.assert_allclose(y_tm, y_ref.T, atol=2e-5)


TOPOLOGIES = [
    (44100.0, 48000.0, Quality.HIGH),     # fused exact-rational
    (96000.0, 48000.0, Quality.HIGH),     # integer decimation
    (48000.0, 44100.0, Quality.HIGH),     # fused frac-down
]


class TestTimeMajorEngine:
    @pytest.mark.parametrize("inr,outr,q", TOPOLOGIES)
    def test_transpose_equivalent_to_enginecore(self, inr, outr, q):
        plan = plan_engine(inr, outr, q)
        s = 3
        n = 20000
        x = (RNG.normal(size=(s, n)) * 0.5).astype(np.float64)

        ref_eng = EngineCore(plan, batch=s, block=2048, dtype=jnp.float64)
        mult = ref_eng.device_chunk_multiple
        n_use = (n // mult) * mult
        y_ref = np.concatenate(
            [np.asarray(ref_eng.process_device(jnp.asarray(x[:, :n_use]))),
             np.asarray(ref_eng.flush_device())], axis=1)

        tm = TimeMajorEngine(plan, batch=s, block=2048, dtype=jnp.float64)
        assert tm.chunk_multiple == mult
        y_tm = np.concatenate(
            [np.asarray(tm.process_device(jnp.asarray(x[:, :n_use].T))),
             np.asarray(tm.flush_device())], axis=0)
        assert y_tm.shape == (y_ref.shape[1], s)
        np.testing.assert_allclose(y_tm, y_ref.T, rtol=1e-12, atol=1e-13)

    def test_chunked_matches_single_call(self):
        """Chunking invariance: same canonical grid regardless of chunk
        widths.  Across DIFFERENT widths XLA may tile the contraction
        differently (distinct compiled programs), so the cross-width
        comparison is at f64 rounding, while equal-width re-feeding is
        bit-exact (same program) — the same contract as
        EngineCore.process_device with varying widths."""
        plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
        tm1 = TimeMajorEngine(plan, batch=2, block=2048, dtype=jnp.float64)
        tm2 = TimeMajorEngine(plan, batch=2, block=2048, dtype=jnp.float64)
        tm3 = TimeMajorEngine(plan, batch=2, block=2048, dtype=jnp.float64)
        mult = tm1.chunk_multiple
        n = mult * 40
        xt = (RNG.normal(size=(n, 2)) * 0.5).astype(np.float64)
        y1 = np.concatenate(
            [np.asarray(tm1.process_device(jnp.asarray(xt))),
             np.asarray(tm1.flush_device())], axis=0)
        parts = [np.asarray(tm2.process_device(jnp.asarray(
            xt[lo:lo + mult * 8]))) for lo in range(0, n, mult * 8)]
        parts.append(np.asarray(tm2.flush_device()))
        y2 = np.concatenate(parts, axis=0)
        assert y1.shape == y2.shape
        np.testing.assert_allclose(y1, y2, rtol=1e-12, atol=1e-13)
        # Equal widths -> same compiled program -> bit-exact.
        parts3 = [np.asarray(tm3.process_device(jnp.asarray(
            xt[lo:lo + mult * 8]))) for lo in range(0, n, mult * 8)]
        parts3.append(np.asarray(tm3.flush_device()))
        np.testing.assert_array_equal(y2, np.concatenate(parts3, axis=0))

    def test_rejects_unsupported(self):
        with pytest.raises(NotImplementedError):
            TimeMajorEngine(plan_engine(44100.0, 48001.0, Quality.HIGH),
                            batch=2)
        with pytest.raises(NotImplementedError):
            TimeMajorEngine(plan_engine(48000.0, 96000.0, Quality.HIGH),
                            batch=2)

    def test_validation(self):
        plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
        tm = TimeMajorEngine(plan, batch=2, dtype=jnp.float64)
        with pytest.raises(ValueError):
            tm.process_device(jnp.zeros((5, 2)))       # not a multiple
        with pytest.raises(ValueError):
            tm.process_device(jnp.zeros((tm.chunk_multiple, 3)))
        tm.flush_device()
        with pytest.raises(RuntimeError):
            tm.process_device(jnp.zeros((tm.chunk_multiple, 2)))

    def test_step_counts(self):
        plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
        eng = EngineCore(plan, batch=2, block=2048, dtype=jnp.float64)
        r = eng._rational_rt.T
        ipx, wx, p2 = (eng._rational_ipx, eng._rational_wx,
                       eng._rational_p2)
        carry = jnp.zeros((eng._rational_carry, 2), jnp.float64)
        x = jnp.asarray(RNG.normal(size=(ipx * 16, 2)))
        c2, y, n = _step_banded_tmajor(r, carry, x, ipx=ipx, wx=wx, p2=p2)
        assert int(n) == 16 * p2 and y.shape == (16 * p2, 2)
        assert c2.shape == (eng._rational_carry, 2)
