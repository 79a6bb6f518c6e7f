"""Decimation lowering routing: banded matmul vs FFT overlap-save.

For the DECIMATE topology the default crossover
(oneshot.DECIM_FFT_MIN_TAPS) sits beyond any designable prototype, so
the frames-matmul always serves.  The routing machinery stays live
(GAR_DECIM_FFT_MIN_TAPS): these tests exercise it by lowering the
crossover and pin float64 parity between the two lowerings on both the
one-shot and the streaming path.
"""

from __future__ import annotations

import importlib

import numpy as np
import jax.numpy as jnp
import pytest

osm = importlib.import_module('go_audio_resampler_tpu.engine.oneshot')
from go_audio_resampler_tpu.engine import EngineCore, oneshot, plan_engine
from go_audio_resampler_tpu.filterdesign import Quality

RNG = np.random.default_rng(3)


@pytest.fixture(scope="module")
def long_plan():
    plan = plan_engine(48000.0, 4000.0, Quality.VERY_HIGH)   # 6403 taps
    assert plan.kind == 'decimate'
    return plan


def _routed(plan, x, thresh):
    """Run the one-shot with the decimate crossover moved to ``thresh``."""
    saved = osm.DECIM_FFT_MIN_TAPS
    osm.DECIM_FFT_MIN_TAPS = thresh
    osm._oneshot_jit.clear_cache()
    try:
        return np.asarray(oneshot(plan, x, dtype=np.float64))
    finally:
        osm.DECIM_FFT_MIN_TAPS = saved
        osm._oneshot_jit.clear_cache()


class TestOneshotRouting:

    def test_default_stays_matmul_even_at_design_cap(self, monkeypatch):
        """8191 taps is the designable maximum; the default keeps the
        matmul there."""
        plan = plan_engine(48000.0, 2000.0, Quality.HIGH)
        assert plan.decim_taps == 8191
        assert plan.decim_taps < osm.DECIM_FFT_MIN_TAPS
        import go_audio_resampler_tpu.engine.fftstage as fstage

        def boom(*a, **k):
            raise AssertionError("default must not route decimate FFT")
        monkeypatch.setattr(fstage, "_fft_decimate", boom)
        osm._oneshot_jit.clear_cache()
        try:
            oneshot(plan, RNG.standard_normal((1, 2000)),
                    dtype=np.float64)
        finally:
            osm._oneshot_jit.clear_cache()

    def test_lowered_crossover_routes_fft(self, long_plan, monkeypatch):
        """With the crossover below the prototype the FFT path engages."""
        import go_audio_resampler_tpu.engine.fftstage as fstage
        called = []
        real = fstage._fft_decimate

        def spy(plan, xs, count):
            called.append(plan.decim_taps)
            return real(plan, xs, count)
        monkeypatch.setattr(fstage, "_fft_decimate", spy)
        monkeypatch.setattr(osm, "DECIM_FFT_MIN_TAPS", 0)
        osm._oneshot_jit.clear_cache()
        try:
            oneshot(long_plan, RNG.standard_normal((1, 4000)),
                    dtype=np.float64)
        finally:
            osm._oneshot_jit.clear_cache()
        assert called, "lowered crossover did not take the FFT path"

    def test_f64_parity_between_lowerings(self, long_plan):
        x = RNG.standard_normal((2, 13000))
        y_fft = _routed(long_plan, x, 0)
        y_mm = _routed(long_plan, x, 1 << 30)
        assert y_fft.shape == y_mm.shape
        np.testing.assert_allclose(y_fft, y_mm, rtol=1e-9, atol=1e-12)


class TestStreamingRouting:

    def _fft_engine(self, plan, batch, monkeypatch=None, **kw):
        saved = osm.DECIM_FFT_MIN_TAPS
        osm.DECIM_FFT_MIN_TAPS = 0
        try:
            eng = EngineCore(plan, batch=batch, **kw)
        finally:
            osm.DECIM_FFT_MIN_TAPS = saved
        assert eng._decim_fft
        return eng

    def test_engine_default_is_matmul(self, long_plan):
        eng = EngineCore(long_plan, batch=1, block=2048, dtype=jnp.float64)
        assert not eng._decim_fft

    def test_stream_parity_between_lowerings(self, long_plan):
        x = RNG.standard_normal((2, 30000))
        eng_f = self._fft_engine(long_plan, 2, block=2048,
                                 dtype=jnp.float64)
        got = np.concatenate([eng_f.process(x), eng_f.flush()], axis=1)
        eng_m = EngineCore(long_plan, batch=2, block=2048,
                           dtype=jnp.float64)
        assert not eng_m._decim_fft
        want = np.concatenate([eng_m.process(x), eng_m.flush()], axis=1)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)

    def test_fft_stream_matches_oneshot(self, long_plan):
        x = RNG.standard_normal((1, 25000))
        eng = self._fft_engine(long_plan, 1, block=2048, dtype=jnp.float64)
        got = np.concatenate([eng.process(x), eng.flush()], axis=1)
        want = np.asarray(oneshot(long_plan, x, dtype=np.float64))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)

    def test_fft_step_supports_device_mode(self, long_plan):
        eng = self._fft_engine(long_plan, 1, block=2048, dtype=jnp.float64)
        mult = eng.device_chunk_multiple
        assert mult == long_plan.factor
        x = RNG.standard_normal((1, 10 * 2048))
        n = (x.shape[1] // mult) * mult
        y = np.concatenate([np.asarray(eng.process_device(
            jnp.asarray(x[:, :n]))), np.asarray(eng.flush_device())],
            axis=1)
        eng2 = self._fft_engine(long_plan, 1, block=2048,
                                dtype=jnp.float64)
        want = np.concatenate([eng2.process(x[:, :n]), eng2.flush()],
                              axis=1)
        np.testing.assert_allclose(y, want, rtol=1e-12, atol=1e-13)
