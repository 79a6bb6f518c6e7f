"""float32-path quality floors (the serving compute dtype).

The reference validates float32 vs float64 consistency
(convenience_float32_test.go:222, README.md:361-367: f32 High THD
-145.01 dB vs f64 -145.25).  Here the float32 fused path must still clear
the THD regression floors and hold DC gain; measured on CPU with the same
kernels the device executes.
"""

import numpy as np
import pytest

from go_audio_resampler_tpu.engine import plan_engine, oneshot
from go_audio_resampler_tpu.filterdesign import Quality
from go_audio_resampler_tpu.utils import metrics, signals

N = 65536
FFT = 16384


def resample_f32(x, inr, outr, q):
    plan = plan_engine(inr, outr, q)
    return np.asarray(oneshot(plan, np.asarray(x, np.float32)[None],
                              dtype=np.float32))[0]


class TestFloat32Quality:
    @pytest.mark.parametrize("q,floor", [
        (Quality.HIGH, -140.0), (Quality.VERY_HIGH, -140.0),
        (Quality.LOW, -130.0),
    ])
    def test_thd_floors_f32(self, q, floor):
        x = signals.sine(N, 1000.0, 44100)
        y = resample_f32(x, 44100, 48000, q)
        val = metrics.thd(y.astype(np.float64), 48000, 1000.0, FFT)
        assert val <= floor, f"f32 THD {val:.2f} dB above {floor}"

    def test_dc_gain_f32(self):
        y = resample_f32(signals.dc(16384), 44100, 48000, Quality.HIGH)
        assert abs(metrics.dc_gain(y.astype(np.float64)) - 1.0) <= 1e-3

    def test_f32_tracks_f64(self):
        # README.md:361-367 analog: f32 and f64 land in the same THD class
        x = signals.sine(N, 1000.0, 44100)
        y32 = resample_f32(x, 44100, 48000, Quality.HIGH)
        plan = plan_engine(44100, 48000, Quality.HIGH)
        y64 = np.asarray(oneshot(plan, x[None], dtype=np.float64))[0]
        assert y32.shape == y64.shape
        assert np.abs(y32 - y64).max() < 1e-5
        t32 = metrics.thd(y32.astype(np.float64), 48000, 1000.0, FFT)
        t64 = metrics.thd(y64, 48000, 1000.0, FFT)
        assert t32 <= -145.0 and t64 <= -145.0

    def test_decimation_f32(self):
        x = signals.sine(N, 1000.0, 96000)
        y = resample_f32(x, 96000, 48000, Quality.HIGH)
        val = metrics.thd(y.astype(np.float64), 48000, 1000.0, FFT)
        assert val <= -130.0
