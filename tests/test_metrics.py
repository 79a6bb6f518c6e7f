"""Self-tests for the DSP measurement suite (utils.metrics).

The quality tests are only as trustworthy as the meter; validate THD /
SNR / ripple / PSD / DC on synthetic signals with known answers.
"""

import numpy as np
import pytest

from go_audio_resampler_tpu.utils import metrics, signals


class TestTHDMeter:
    def test_pure_sine_measures_clean(self):
        x = signals.sine(65536, 1000.0, 48000)
        assert metrics.thd(x, 48000, 1000.0) < -150.0

    def test_known_harmonic_level(self):
        # Bin-centered fundamental (scalloping-free): 0.9 + 2nd harmonic
        # at exactly -60 dB
        f0 = 512 * 48000 / 16384.0  # 1500 Hz, bin 512
        x = signals.sine(65536, f0, 48000, 0.9)
        x = x + signals.sine(65536, 2 * f0, 48000, 0.9 * 1e-3)
        val = metrics.thd(x, 48000, f0)
        assert val == pytest.approx(-60.0, abs=1.0)

    def test_multiple_harmonics_sum_power(self):
        f0 = 512 * 48000 / 16384.0
        x = signals.sine(65536, f0, 48000, 0.9)
        for h in (2, 3, 4):
            x = x + signals.sine(65536, f0 * h, 48000, 0.9 * 1e-3)
        # 3 equal harmonics: +10*log10(3) ~ 4.8 dB above one
        val = metrics.thd(x, 48000, f0)
        assert val == pytest.approx(-60.0 + 4.77, abs=1.0)


class TestSNRMeter:
    def test_leakage_floor_and_monotonicity(self):
        # The reference's SNR methodology (Hann window, fundamental +-3
        # bins) counts the window's spectral leakage as "noise", flooring
        # the measure around ~43 dB for a perfectly clean tone — which is
        # exactly why the captured libsoxr "snr_44100_48000" golden value
        # is only 35.5 dB.  This meter reproduces that behavior.
        rng = np.random.default_rng(7)
        sig = signals.sine(65536, 1000.0, 48000, 0.9)
        clean = metrics.snr(sig, 48000, 1000.0)
        assert clean == pytest.approx(43.5, abs=3.0)
        light = metrics.snr(sig + rng.normal(0, 1e-4, 65536), 48000, 1000.0)
        heavy = metrics.snr(sig + rng.normal(0, 1e-1, 65536), 48000, 1000.0)
        assert clean >= light - 0.5 > heavy
        # heavy noise dominates leakage: 10log10(0.405/1e-2) ~ 16 dB
        assert heavy == pytest.approx(16.1, abs=3.0)


class TestRippleMeter:
    def test_flat_multitone_low_ripple(self):
        # Bin-straddling scalloping bounds the meter's resolution at
        # ~+-0.3 dB (reference methodology: peak of +-2 bins with a Hann
        # window) — flat input must read below that bound.
        freqs = [500.0 * k for k in range(1, 11)]
        x = signals.multitone(65536, freqs, 48000, 0.05)
        r = metrics.passband_ripple(x, 48000, freqs)
        assert r.ripple_peak_peak < 1.0

    def test_known_imbalance(self):
        # Use bin-centered frequencies so scalloping cancels exactly.
        f1 = 1024 * 48000 / 16384.0
        f2 = 2048 * 48000 / 16384.0
        x = (signals.multitone(65536, [f1], 48000, 0.05)
             + signals.multitone(65536, [f2], 48000, 0.05 * 10 ** (-1 / 20)))
        r = metrics.passband_ripple(x, 48000, [f1, f2])
        assert r.ripple_peak_peak == pytest.approx(1.0, abs=0.15)


class TestPSD:
    def test_peak_frequency(self):
        x = signals.sine(65536, 3000.0, 48000)
        freqs, psd_db = metrics.psd(x, 48000)
        assert freqs[int(np.argmax(psd_db))] == pytest.approx(3000.0, abs=10)

    def test_peak_energy_band_selection(self):
        x = (signals.sine(65536, 3000.0, 48000, 0.9)
             + signals.sine(65536, 10000.0, 48000, 0.009))
        freqs, psd_db = metrics.psd(x, 48000)
        in_band = metrics.peak_energy_db(freqs, psd_db, 9000, 11000)
        main = metrics.peak_energy_db(freqs, psd_db, 2000, 4000)
        assert main - in_band == pytest.approx(40.0, abs=2.0)

    def test_empty_band(self):
        freqs, psd_db = metrics.psd(signals.dc(8192), 48000)
        assert metrics.peak_energy_db(freqs, psd_db, 1e9, 2e9) == -200.0


class TestDCAndAmplitude:
    def test_dc_gain_skips_edges(self):
        x = np.concatenate([np.zeros(100), np.ones(800), np.zeros(100)])
        assert metrics.dc_gain(x) == pytest.approx(1.0)

    def test_amplitude(self):
        x = signals.sine(8192, 440.0, 48000, 0.7)
        assert metrics.amplitude(x) == pytest.approx(0.7, abs=1e-3)


class TestConvLowerings:
    def test_banded_matches_frames(self):
        # The accelerator-default banded lowering must equal the frames reference
        # across kernel lengths, strides, and multi-filter shapes.
        import jax.numpy as jnp
        from go_audio_resampler_tpu.ops import convolve as cv
        rng = np.random.default_rng(0)
        try:
            for s, n, f, t, stride in [(3, 5000, 2, 200, 1),
                                       (2, 1000, 1, 33, 1),
                                       (2, 4000, 1, 901, 2),
                                       (1, 300, 4, 16, 3),
                                       (2, 250, 2, 250, 1)]:
                x = jnp.asarray(rng.normal(size=(s, n)))
                k = jnp.asarray(rng.normal(size=(f, t)))
                cv.set_conv_impl('frames')
                a = np.asarray(cv.conv1d_poly(x, k, stride))
                cv.set_conv_impl('banded')
                b = np.asarray(cv.conv1d_poly(x, k, stride))
                assert a.shape == b.shape
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)
        finally:
            cv.set_conv_impl(None)
