"""Public API and behavioral-contract tests.

Ports the reference's tier-4 contracts (SURVEY.md section 4.4): config
validation, preset expansion, ProcessInto no-state-advance on error,
EstimateOutput upper bound, flush-multi == per-channel flush,
parallel(batched) == sequential, float32/float64 consistency, stereo
one-shot == two mono runs, pipeline planner decomposition.
"""

import numpy as np
import pytest

import go_audio_resampler_tpu as gar
from go_audio_resampler_tpu.pipeline import (build_pipeline, QualityParams,
                                             StageType, SampleFIFO)
from go_audio_resampler_tpu.utils import signals


def sine(n, rate, f=997.0):
    return signals.sine(n, f, rate)


class TestConfigValidation:
    def test_valid(self):
        gar.Config(44100, 48000).validate()

    @pytest.mark.parametrize("tier", ["auto", "highest", "high", "default"])
    def test_precision_values(self, tier):
        gar.Config(44100, 48000, precision=tier).validate()
        with pytest.raises(gar.InvalidConfigError, match="precision"):
            gar.Config(44100, 48000, precision="fast").validate()

    def test_precision_tiers_equal_stream(self):
        """On CPU every tier computes in full float32: identical output."""
        import numpy as np
        x = np.random.default_rng(1).normal(size=4096).astype(np.float32)
        outs = []
        for tier in ("auto", "highest", "high", "default"):
            r = gar.new_resampler(gar.Config(
                48000, 8000, channels=1,
                quality=gar.QualitySpec(preset=gar.QualityPreset.HIGH),
                dtype=np.float32, precision=tier))
            outs.append(np.concatenate([r.process(x), r.flush()]))
        for o in outs[1:]:
            np.testing.assert_array_equal(outs[0], o)

    def test_dispatch_option_is_gone(self):
        with pytest.raises(TypeError):
            gar.Config(44100, 48000, dispatch="xla")

    @pytest.mark.parametrize("inr,outr", [
        (0, 48000), (48000, 0), (-1, 48000), (float('nan'), 48000),
        (48000, float('inf')),
    ])
    def test_bad_rates(self, inr, outr):
        with pytest.raises(gar.InvalidConfigError):
            gar.Config(inr, outr).validate()

    def test_bad_channels(self):
        with pytest.raises(gar.InvalidConfigError):
            gar.Config(44100, 48000, channels=0).validate()
        with pytest.raises(gar.InvalidConfigError):
            gar.Config(44100, 48000, channels=257).validate()

    def test_ratio_bounds(self):
        with pytest.raises(gar.InvalidConfigError):
            gar.Config(48000, 48000 / 300).validate()

    def test_custom_quality_validation(self):
        q = gar.QualitySpec(preset=gar.QualityPreset.CUSTOM, precision=5)
        with pytest.raises(gar.InvalidConfigError):
            gar.Config(44100, 48000, quality=q).validate()
        q = gar.QualitySpec(preset=gar.QualityPreset.CUSTOM, precision=20,
                            passband_end=0.9, stopband_begin=0.8)
        with pytest.raises(gar.InvalidConfigError):
            gar.Config(44100, 48000, quality=q).validate()

    def test_none_config(self):
        with pytest.raises(gar.InvalidConfigError):
            gar.new_resampler(None)


class TestPresets:
    def test_preset_expansion(self):
        # resample.go:217-267 values
        spec = gar.get_preset_spec(gar.QualityPreset.HIGH)
        assert spec.precision == 24
        assert spec.passband_end == 0.95
        assert spec.stopband_begin == 0.99
        spec = gar.get_preset_spec(gar.QualityPreset.VERY_HIGH)
        assert spec.precision == 32
        spec = gar.get_preset_spec(gar.QualityPreset.QUICK)
        assert spec.precision == 8

    def test_precision_to_engine_quality(self):
        # stages.go:93-108
        eq = gar.EngineQuality
        assert gar.precision_to_engine_quality(8) == eq.QUICK
        assert gar.precision_to_engine_quality(16) == eq.LOW
        assert gar.precision_to_engine_quality(20) == eq.HIGH
        assert gar.precision_to_engine_quality(24) == eq.BITS_24
        assert gar.precision_to_engine_quality(28) == eq.VERY_HIGH
        assert gar.precision_to_engine_quality(32) == eq.BITS_32


class TestPipelinePlanner:
    def test_quick_single_cubic(self):
        p = build_pipeline(48000 / 44100, QualityParams(8, 0.7, 1.0))
        assert [s.type for s in p.stages] == [StageType.CUBIC]

    def test_small_downratio_halfbands(self):
        # ratio 1/6 < 0.5: two half-band stages + residual
        p = build_pipeline(8000 / 48000, QualityParams(24, 0.95, 0.99))
        kinds = [s.type for s in p.stages]
        assert kinds[:2] == [StageType.HALF_BAND, StageType.HALF_BAND]
        assert len(kinds) == 3

    def test_big_upratio_halfbands(self):
        p = build_pipeline(6.0, QualityParams(24, 0.95, 0.99))
        kinds = [s.type for s in p.stages]
        assert kinds[0] == StageType.HALF_BAND
        assert kinds[-1] in (StageType.POLYPHASE, StageType.FFT)

    def test_fft_for_high_precision(self):
        # precision >= 28 -> FFT stage (pipeline.go:320-325)
        p = build_pipeline(48000 / 44100, QualityParams(32, 0.99, 0.995))
        assert p.stages[-1].type == StageType.FFT

    def test_fft_for_common_ratio(self):
        p = build_pipeline(44100 / 48000, QualityParams(24, 0.95, 0.99))
        assert p.stages[-1].type == StageType.FFT

    def test_latency_positive(self):
        p = build_pipeline(0.25, QualityParams(24, 0.95, 0.99))
        assert p.total_latency > 0


class TestResamplerPipelinePath:
    def test_mono_roundtrip(self):
        r = gar.new_resampler(gar.Config(44100, 48000))
        x = sine(8000, 44100)
        y = np.concatenate([r.process(x), r.flush()])
        assert abs(len(y) - len(x) * 48000 / 44100) < 200
        assert np.all(np.isfinite(y))

    def test_process_multi_channels(self):
        r = gar.new_multi_channel(48000, 44100, 4,
                                  gar.QualityPreset.HIGH)
        chans = [sine(4000, 48000, f) for f in (400, 800, 1600, 3200)]
        outs = r.process_multi(chans)
        tails = r.flush_multi()
        assert len(outs) == 4 and len(tails) == 4
        full = [np.concatenate([o, t]) for o, t in zip(outs, tails)]
        assert len({len(f) for f in full}) == 1  # equal lengths

    def test_parallel_equals_sequential(self):
        # parallel_test.go:12-150 analog: batched == one-channel runs
        chans = [sine(3000, 48000, f) for f in (500, 1500)]
        r2 = gar.new_multi_channel(48000, 32000, 2, gar.QualityPreset.HIGH)
        outs = r2.process_multi(chans)
        tails = r2.flush_multi()
        batched = [np.concatenate([o, t]) for o, t in zip(outs, tails)]
        for i in range(2):
            r1 = gar.new_multi_channel(48000, 32000, 1, gar.QualityPreset.HIGH)
            (o,) = r1.process_multi([chans[i]])
            (t,) = r1.flush_multi()
            single = np.concatenate([o, t])
            np.testing.assert_allclose(batched[i], single, rtol=1e-12, atol=1e-15)

    def test_process_into_contract(self):
        # processinto_test.go:36-228: too-small buffer errors BEFORE state
        r = gar.new_simple(44100, 48000)
        x = sine(1000, 44100)
        small = np.zeros(10)
        with pytest.raises(gar.BufferTooSmallError):
            r.process_into(x, small)
        assert r.get_statistics()["samplesIn"] == 0  # state untouched
        big = np.zeros(r.estimate_output(len(x)))
        n = r.process_into(x, big)
        assert 0 <= n <= len(big)

    def test_process_float32(self):
        r = gar.new_simple(44100, 48000)
        y = r.process_float32(sine(2000, 44100).astype(np.float32))
        assert y.dtype == np.float32

    def test_reset(self):
        r = gar.new_simple(44100, 48000)
        x = sine(3000, 44100)
        a = np.concatenate([r.process(x), r.flush()])
        r.reset()
        b = np.concatenate([r.process(x), r.flush()])
        np.testing.assert_array_equal(a, b)

    def test_get_info(self):
        r = gar.new_simple(44100, 48000)
        info = gar.get_info(r)
        assert info.filter_length > 0
        assert info.latency > 0
        assert info.memory_usage > 0
        assert "xla" in info.simd_type

    def test_statistics(self):
        r = gar.new_simple(44100, 48000)
        x = sine(1000, 44100)
        r.process(x)
        r.flush()
        st = r.get_statistics()
        assert st["samplesIn"] == 1000
        assert st["samplesOut"] > 0

    def test_unequal_channel_lengths_rejected(self):
        r = gar.new_stereo(44100, 48000)
        with pytest.raises(gar.InvalidConfigError):
            r.process_multi([np.zeros(10), np.zeros(5)])

    def test_stub_engine_contract(self):
        # stages.go:122-189 stubStage analog: nearest-neighbor fallback,
        # pass-through ratio adjustment, empty flush, zero state.
        from go_audio_resampler_tpu.api import StubEngine
        s = StubEngine(1.5, batch=2, dtype=np.float64)
        x = np.arange(20, dtype=np.float64).reshape(2, 10)
        y = s.process(x)
        assert y.shape == (2, 15)
        src = np.minimum((np.arange(15) / 1.5).astype(np.int64), 9)
        np.testing.assert_array_equal(y, x[:, src])
        assert s.flush().shape == (2, 0)
        assert s.get_latency() == 0 and s.get_ratio() == 1.5
        assert s.get_statistics() == {"samplesIn": 10, "samplesOut": 15}
        s.reset()
        assert s.get_statistics() == {"samplesIn": 0, "samplesOut": 0}
        assert s.process(np.zeros((2, 0))).shape == (2, 0)

    def test_mixed_mono_multi_rejected(self):
        # Broadcasting mono into a multi-channel stream would silently
        # corrupt every channel; the mix must raise instead.
        r = gar.new_stereo(44100, 48000)
        r.process_multi([sine(500, 44100), sine(500, 44100, 900)])
        with pytest.raises(gar.ResamplerError):
            r.process(sine(500, 44100))
        r.reset()
        r.process(sine(500, 44100))
        with pytest.raises(gar.ResamplerError):
            r.process_multi([sine(500, 44100), sine(500, 44100, 900)])
        # reset clears the mode latch; mono-only resamplers are unaffected
        r.reset()
        r.process_multi([sine(500, 44100), sine(500, 44100, 900)])
        m = gar.new_simple(44100, 48000)
        m.process(sine(500, 44100))
        m.process_multi([sine(500, 44100)])


class TestSimpleResamplers:
    def test_direct_engine_matches_oneshot(self):
        x = sine(5000, 44100)
        r = gar.new_engine(44100, 48000, gar.QualityPreset.HIGH)
        streamed = np.concatenate([r.process(x), r.flush()])
        oneshot_y = gar.resample_mono(x, 44100, 48000, gar.QualityPreset.HIGH)
        np.testing.assert_allclose(streamed, oneshot_y, rtol=1e-9, atol=1e-12)

    def test_float32_engine(self):
        x = sine(5000, 44100).astype(np.float32)
        r = gar.new_engine_float32(44100, 48000, gar.QualityPreset.HIGH)
        y = np.concatenate([r.process(x), r.flush()])
        assert y.dtype == np.float32
        y64 = gar.resample_mono(x.astype(np.float64), 44100, 48000,
                                gar.QualityPreset.HIGH)
        assert y.shape == y64.shape
        np.testing.assert_allclose(y, y64, atol=1e-4)

    def test_process_into_simple(self):
        r = gar.new_engine(44100, 48000)
        x = sine(512, 44100)
        with pytest.raises(gar.BufferTooSmallError):
            r.process_into(x, np.zeros(3))
        out = np.zeros(r.estimate_output(len(x)))
        n = r.process_into(x, out)
        assert n >= 0

    def test_stereo_oneshot_matches_two_mono(self):
        # convenience_stereo_test.go:40-75 contract
        l = sine(4000, 44100, 440.0)
        r = sine(4000, 44100, 997.0)
        lo, ro = gar.resample_stereo(l, r, 44100, 48000)
        lm = gar.resample_mono(l, 44100, 48000)
        rm = gar.resample_mono(r, 44100, 48000)
        np.testing.assert_allclose(lo, lm, rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(ro, rm, rtol=1e-12, atol=1e-15)

    def test_stereo_unequal_lengths(self):
        l = sine(3000, 44100)
        r = sine(2000, 44100)
        lo, ro = gar.resample_stereo(l, r, 44100, 48000)
        assert len(lo) != len(ro)

    def test_float32_consistency(self):
        # convenience_float32_test.go:222 analog
        x = sine(8000, 44100)
        y64 = gar.resample_mono(x, 44100, 48000)
        y32 = gar.resample_mono_float32(x.astype(np.float32), 44100, 48000)
        assert y64.shape == y32.shape
        np.testing.assert_allclose(y32, y64, atol=1e-4)


class TestInterleave:
    def test_roundtrip(self):
        l = np.arange(10.0)
        r = -np.arange(10.0)
        inter = gar.interleave_to_stereo(l, r)
        assert list(inter[:4]) == [0.0, -0.0, 1.0, -1.0]
        l2, r2 = gar.deinterleave_from_stereo(inter)
        np.testing.assert_array_equal(l, l2)
        np.testing.assert_array_equal(r, r2)

    def test_min_length(self):
        inter = gar.interleave_to_stereo(np.ones(5), np.ones(3))
        assert len(inter) == 6


class TestSampleFIFO:
    def test_write_read_wrap(self):
        # buffer_test.go:20-108 analogs
        f = SampleFIFO(batch=2, capacity=4)
        f.write(np.arange(6.0).reshape(2, 3))
        assert f.available() == 3
        out = f.read(2)
        np.testing.assert_array_equal(out, [[0, 1], [3, 4]])
        f.write(np.ones((2, 5)))  # forces growth
        assert f.available() == 6

    def test_read_into_short_dst(self):
        f = SampleFIFO(batch=1)
        f.write(np.arange(8.0)[None])
        dst = np.zeros((1, 3))
        n = f.read_into(dst)
        assert n == 3
        np.testing.assert_array_equal(dst[0], [0, 1, 2])
        assert f.available() == 5

    def test_reset(self):
        f = SampleFIFO(batch=1)
        f.write(np.ones((1, 4)))
        f.reset()
        assert f.available() == 0


class TestPipelineStreamMatchesStageOracle:
    def test_single_stage_bit_exact(self):
        # The pipeline Resampler's stream must equal the one-shot oracle
        # of the SAME stage filter (High preset -> precision 24 ->
        # BITS_24, stages.go:76-108), independent of caller chunking.
        # (The direct-engine High filter is a different filter;
        # cross-quality comparison is not sample-exact.)  On a single
        # device the match is bit-exact; under the suite's virtual
        # 8-device CPU mesh XLA partitions reductions differently per
        # program, so equality is to ULP.
        from go_audio_resampler_tpu.api import precision_to_engine_quality
        from go_audio_resampler_tpu.engine import plan_engine, oneshot
        x = sine(20000, 44100)
        r = gar.new_resampler(gar.Config(
            44100, 48000,
            quality=gar.QualitySpec(preset=gar.QualityPreset.HIGH),
            dtype=np.float64))
        outs = [r.process(c) for c in np.array_split(x, 7)]
        outs.append(r.flush())
        s = np.concatenate(outs)
        plan = plan_engine(44100.0, 48000.0, precision_to_engine_quality(24))
        oracle = np.asarray(oneshot(plan, x[None], dtype=np.float64))[0]
        assert len(s) == len(oracle)
        np.testing.assert_allclose(s, oracle, rtol=1e-12, atol=1e-14)
