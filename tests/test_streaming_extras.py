"""Checkpoint/resume, edge-case robustness ("fuzz" tier), WAV I/O, and the
linear interpolation kernel.

Mirrors the reference's fuzz tier (fuzz_test.go:11-73), buffer-integrity
contract (buffer_integrity_test.go:18-400) and checkpoint/resume analog
(SURVEY.md section 5).
"""

import numpy as np
import pytest

import go_audio_resampler_tpu as gar
from go_audio_resampler_tpu.engine import (EngineCore, plan_engine, oneshot,
                                           save_stream_state,
                                           load_stream_state,
                                           EngineConfigError)
from go_audio_resampler_tpu.engine import stages
from go_audio_resampler_tpu.filterdesign import Quality
from go_audio_resampler_tpu.utils import signals
from go_audio_resampler_tpu.utils.wav import WavReader, WavWriter, _load_native

from testutil import assert_no_nan_or_inf


class TestCheckpointResume:
    def test_resume_bit_identical(self, tmp_path):
        plan = plan_engine(44100, 48000, Quality.HIGH)
        x = signals.sine(6000, 997.0, 44100)

        # Uninterrupted run
        eng = EngineCore(plan, batch=1, block=512, dtype=np.float64)
        full = np.concatenate([eng.process(x)[0], eng.flush()[0]])

        # Interrupted run: process half, snapshot, restore into a fresh
        # engine, continue
        eng_a = EngineCore(plan, batch=1, block=512, dtype=np.float64)
        part1 = eng_a.process(x[:3000])[0]
        ckpt = tmp_path / "stream.npz"
        save_stream_state(eng_a, ckpt)

        eng_b = EngineCore(plan, batch=1, block=512, dtype=np.float64)
        load_stream_state(eng_b, ckpt)
        part2 = eng_b.process(x[3000:])[0]
        part3 = eng_b.flush()[0]
        resumed = np.concatenate([part1, part2, part3])
        np.testing.assert_array_equal(resumed, full)

    def test_resume_portable_across_precision_pins(self, tmp_path):
        """A snapshot is tier-independent: a stream saved from a
        precision='high'-pinned engine resumes bit-identically on an
        'auto' engine (state is samples + counters, never lowering
        internals)."""
        plan = plan_engine(44100, 48000, Quality.HIGH)
        x = signals.sine(6000, 997.0, 44100)

        eng = EngineCore(plan, batch=1, block=512, dtype=np.float64)
        full = np.concatenate([eng.process(x)[0], eng.flush()[0]])

        eng_a = EngineCore(plan, batch=1, block=512, dtype=np.float64,
                           precision="high")
        part1 = eng_a.process(x[:3000])[0]
        ckpt = tmp_path / "stream_high.npz"
        save_stream_state(eng_a, ckpt)

        eng_b = EngineCore(plan, batch=1, block=512, dtype=np.float64,
                           precision="auto")
        load_stream_state(eng_b, ckpt)
        resumed = np.concatenate(
            [part1, eng_b.process(x[3000:])[0], eng_b.flush()[0]])
        np.testing.assert_array_equal(resumed, full)

    def test_shape_mismatch_rejected(self, tmp_path):
        plan = plan_engine(44100, 48000, Quality.HIGH)
        eng = EngineCore(plan, batch=1, block=512, dtype=np.float64)
        ckpt = tmp_path / "s.npz"
        save_stream_state(eng, ckpt)
        other = EngineCore(plan, batch=2, block=512, dtype=np.float64)
        with pytest.raises(ValueError):
            load_stream_state(other, ckpt)

    def test_bad_file_rejected(self, tmp_path):
        p = tmp_path / "junk.npz"
        np.savez(p, magic=np.zeros(3, np.uint8))
        plan = plan_engine(44100, 48000, Quality.HIGH)
        eng = EngineCore(plan, batch=1, block=512, dtype=np.float64)
        with pytest.raises((ValueError, KeyError)):
            load_stream_state(eng, p)

    def test_dtype_mismatch_rejected(self, tmp_path):
        # ADVICE r1: a float32 checkpoint must not restore into a float64
        # engine of identical shapes.
        plan = plan_engine(44100, 48000, Quality.HIGH)
        eng32 = EngineCore(plan, batch=1, block=512, dtype=np.float32)
        ckpt = tmp_path / "f32.npz"
        save_stream_state(eng32, ckpt)
        eng64 = EngineCore(plan, batch=1, block=512, dtype=np.float64)
        with pytest.raises(ValueError, match="dtype"):
            load_stream_state(eng64, ckpt)


class TestStreamingHighRatioQuick:
    """ADVICE r1 (high): walk32 int32 overflow at upsampling ratios >~16.

    The streaming cubic cap must be clamped to < 2^15 like the polyphase
    cap; without the clamp, j*s_f0 / j*s_f1 in stages.walk32 wrap int32 and
    shift the integer sample index, silently corrupting QUICK output.
    """

    @pytest.mark.parametrize("ratio", [8.0, 20.0, 40.0, 150.0, 255.9])
    def test_streaming_matches_oneshot(self, ratio):
        plan = plan_engine(1000.0, 1000.0 * ratio, Quality.QUICK)
        rng = np.random.default_rng(7)
        x = rng.standard_normal((1, 700))
        ref = np.asarray(oneshot(plan, x, dtype=np.float64))
        eng = EngineCore(plan, batch=1, block=2048, dtype=np.float64)
        got = np.concatenate([eng.process(x), eng.flush()], axis=1)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


class TestFuzzEdgeCases:
    """fuzz_test.go:11-73 analogs (deterministic corpus)."""

    @pytest.mark.parametrize("inr,outr", [
        (1.0, 256.0), (256.0, 1.0), (44100.0, 44100.0),
        (8000.0, 192000.0), (192000.0, 8000.0), (44101.0, 48001.0),
    ])
    def test_extreme_but_valid_ratios(self, inr, outr):
        plan = plan_engine(inr, outr, Quality.LOW)
        y = np.asarray(oneshot(plan, np.ones((1, 64)), dtype=np.float64))
        assert_no_nan_or_inf(y)

    def test_invalid_rates(self):
        for inr, outr in [(0, 48000), (-5, 48000), (float('nan'), 48000),
                          (48000, float('inf')), (1, 48000 * 10)]:
            with pytest.raises(EngineConfigError):
                plan_engine(inr, outr, Quality.HIGH)

    def test_nan_inf_samples_pass_through_finite_filter(self):
        # NaN/Inf inputs produce NaN/Inf outputs (linear filter), never crash
        x = np.zeros((1, 1000))
        x[0, 500] = np.nan
        plan = plan_engine(44100, 48000, Quality.HIGH)
        y = np.asarray(oneshot(plan, x, dtype=np.float64))
        assert np.isnan(y).any()
        assert y.shape[1] == plan.lengths.canonical(1000)

    def test_single_sample_and_tiny_inputs(self):
        for n in (1, 2, 3, 5):
            for inr, outr, q in [(44100, 48000, Quality.HIGH),
                                 (96000, 48000, Quality.HIGH),
                                 (44100, 48000, Quality.QUICK)]:
                plan = plan_engine(inr, outr, q)
                y = np.asarray(oneshot(plan, np.ones((1, n)), dtype=np.float64))
                assert y.shape[1] == plan.lengths.canonical(n)

    def test_denormal_and_huge_values(self):
        plan = plan_engine(44100, 48000, Quality.HIGH)
        for scale in (1e-300, 1e300):
            y = np.asarray(oneshot(plan, np.full((1, 512), scale),
                                   dtype=np.float64))
            assert_no_nan_or_inf(y)


class TestBufferIntegrity:
    def test_outputs_independent_across_calls(self):
        # buffer_integrity_test.go:18-400: an earlier returned output must
        # not be modified by later process calls
        plan = plan_engine(96000, 48000, Quality.HIGH)
        eng = EngineCore(plan, batch=1, block=512, dtype=np.float64)
        x1 = signals.sine(2048, 1000.0, 96000)
        x2 = signals.white_noise(2048)
        y1 = eng.process(x1)
        snapshot = y1.copy()
        eng.process(x2)
        eng.flush()
        np.testing.assert_array_equal(y1, snapshot)


class TestLinearKernel:
    def test_linear_interpolation_values(self):
        # ramp input: linear interpolation reproduces the ramp exactly
        plan = plan_engine(44100, 88200, Quality.QUICK)  # step for 2x
        cap = 64
        state = stages.CubicState(
            carry=np.zeros((1, 3)), at_int=stages.I32(0),
            at_f1=stages.I32(0), at_f0=stages.I32(0))
        import jax.numpy as jnp
        x = jnp.asarray(np.arange(1.0, 17.0)[None, :])
        step32 = plan.cubic_step
        new_state, y, valid, n = stages.linear_process(state, x, step32, cap)
        y = np.asarray(y)[0][: int(n)]
        # positions k/2 between samples: prev/cur midpoints
        # first outputs interpolate between carry zeros and the ramp
        assert_no_nan_or_inf(y)
        # interior: midpoint between consecutive integers ends in .5
        interior = y[6:20]
        fracs = interior % 0.5
        assert np.allclose(fracs, 0.0, atol=1e-9)


class TestWavIO:
    @pytest.mark.parametrize("bits,tol", [(16, 1e-4), (24, 3e-7), (32, 1e-7)])
    @pytest.mark.parametrize("native", [True, False])
    def test_roundtrip(self, tmp_path, bits, tol, native):
        if native and _load_native() is None:
            pytest.skip("native wavio unavailable")
        t = np.arange(1000) / 44100
        sig = np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                        -0.5 * np.sin(2 * np.pi * 440 * t)], axis=1)
        p = tmp_path / f"t{bits}.wav"
        w = WavWriter(p, 44100, 2, bits, use_native=native)
        w.write(sig.astype(np.float32))
        w.close()
        r = WavReader(p, use_native=native)
        assert (r.sample_rate, r.channels, r.bits) == (44100, 2, bits)
        got = r.read(5000)
        r.close()
        assert got.shape == sig.shape
        assert np.abs(got - sig).max() < tol

    def test_clamping(self, tmp_path):
        p = tmp_path / "clip.wav"
        w = WavWriter(p, 8000, 1, 16, use_native=False)
        w.write(np.array([[2.0], [-2.0]], np.float32))
        w.close()
        r = WavReader(p, use_native=False)
        got = r.read(10)
        assert np.abs(got).max() <= 1.0

    def test_bad_file(self, tmp_path):
        p = tmp_path / "junk.wav"
        p.write_bytes(b"this is not a wav file at all.....")
        with pytest.raises(ValueError):
            WavReader(p, use_native=False)

    def test_invalid_bits(self, tmp_path):
        with pytest.raises(ValueError):
            WavWriter(tmp_path / "x.wav", 8000, 1, 12)

    @pytest.mark.parametrize("wnative", [True, False])
    @pytest.mark.parametrize("rnative", [True, False])
    def test_float32_roundtrip_exact(self, tmp_path, wnative, rnative):
        """IEEE-float output (bits='32f') is bit-exact and unclamped,
        including values above full scale, across both writer/reader
        implementations."""
        if (wnative or rnative) and _load_native() is None:
            pytest.skip("native wavio unavailable")
        rng = np.random.RandomState(7)
        sig = (rng.normal(size=(777, 2)) * 1.5).astype(np.float32)
        p = tmp_path / "f.wav"
        w = WavWriter(p, 96000, 2, "32f", use_native=wnative)
        w.write(sig[:300])
        w.write(sig[300:])
        w.close()
        r = WavReader(p, use_native=rnative)
        assert (r.sample_rate, r.channels, r.bits) == (96000, 2, 32)
        assert r.num_frames == 777
        got = r.read(2000)
        r.close()
        assert np.array_equal(got, sig)
        assert np.abs(got).max() > 1.0  # headroom preserved, not clamped

    def test_float32_requires_32(self, tmp_path):
        with pytest.raises(ValueError):
            WavWriter(tmp_path / "x.wav", 8000, 1, "24f")


class TestCLI:
    def test_resample_wav_end_to_end(self, tmp_path):
        from go_audio_resampler_tpu.cli import resample_wav
        t = np.arange(4410) / 44100
        sig = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
        inp = tmp_path / "in.wav"
        outp = tmp_path / "out.wav"
        w = WavWriter(inp, 44100, 1, 16, use_native=False)
        w.write(sig)
        w.close()
        rc = resample_wav.run([str(inp), str(outp), "-rate", "48000",
                               "-quality", "medium"])
        assert rc == 0
        r = WavReader(outp, use_native=False)
        assert r.sample_rate == 48000
        assert abs(r.num_frames - 4410 * 48000 / 44100) < 100

    def test_resample_wav_float_output(self, tmp_path):
        from go_audio_resampler_tpu.cli import resample_wav
        t = np.arange(4410) / 44100
        sig = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
        inp = tmp_path / "in.wav"
        outp = tmp_path / "out.wav"
        w = WavWriter(inp, 44100, 1, 16, use_native=False)
        w.write(sig)
        w.close()
        rc = resample_wav.run([str(inp), str(outp), "-rate", "48000",
                               "-quality", "medium", "-bits", "32f"])
        assert rc == 0
        r = WavReader(outp, use_native=False)
        # format tag 3, 32-bit float payload
        assert getattr(r, "_format", 3) == 3
        assert (r.sample_rate, r.bits) == (48000, 32)
        got = r.read(r.num_frames)
        assert got.dtype == np.float32 and got.shape[0] > 4700

    def test_resample_wav_missing_input(self, tmp_path):
        from go_audio_resampler_tpu.cli import resample_wav
        rc = resample_wav.run([str(tmp_path / "none.wav"),
                               str(tmp_path / "o.wav")])
        assert rc == 1

    def test_info_tool(self, capsys):
        from go_audio_resampler_tpu.cli import resample_info
        assert resample_info.run(["-in", "44100", "-out", "48000"]) == 0
        out = capsys.readouterr().out
        assert "dft+polyphase" in out

    def test_analyze_filter_tool(self, capsys):
        from go_audio_resampler_tpu.cli import analyze_filter
        assert analyze_filter.run(["-phases", "8", "-taps", "16"]) == 0
        assert "DC gain" in capsys.readouterr().out


class TestCLIBatch:
    def test_batch_mode(self, tmp_path):
        from go_audio_resampler_tpu.cli import resample_wav
        indir = tmp_path / "in"
        outdir = tmp_path / "out"
        indir.mkdir()
        lengths = [2205, 4410, 1103]
        for i, n in enumerate(lengths):
            t = np.arange(n) / 44100
            w = WavWriter(indir / f"f{i}.wav", 44100, 1, 16, use_native=False)
            w.write((0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32))
            w.close()
        rc = resample_wav.run(
            [str(indir / f"f{i}.wav") for i in range(3)]
            + ["-outdir", str(outdir), "-rate", "48000"])
        assert rc == 0
        for i, n in enumerate(lengths):
            r = WavReader(outdir / f"f{i}.wav", use_native=False)
            assert r.sample_rate == 48000
            assert abs(r.num_frames - n * 48000 / 44100) < 100

    def test_single_file_arg_errors(self, tmp_path):
        from go_audio_resampler_tpu.cli import resample_wav
        assert resample_wav.run([str(tmp_path / "x.wav")]) == 2

    def test_basename_collision_rejected(self, tmp_path, capsys):
        # ADVICE r1: two inputs with the same basename must not silently
        # overwrite each other's output in -outdir.
        from go_audio_resampler_tpu.cli import resample_wav
        for sub in ("a", "b"):
            d = tmp_path / sub
            d.mkdir()
            w = WavWriter(d / "same.wav", 44100, 1, 16, use_native=False)
            w.write(np.zeros((100, 1), np.float32))
            w.close()
        rc = resample_wav.run([str(tmp_path / "a" / "same.wav"),
                               str(tmp_path / "b" / "same.wav"),
                               "-outdir", str(tmp_path / "out"),
                               "-rate", "48000"])
        assert rc == 1
        assert "collision" in capsys.readouterr().err


class TestCLIPrecisionFlag:

    def test_precision_flag_accepted(self, tmp_path):
        from go_audio_resampler_tpu.cli import resample_wav
        from go_audio_resampler_tpu.utils.wav import WavReader, WavWriter
        t = np.arange(4410) / 44100
        sig = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
        inp = tmp_path / "in.wav"
        outp = tmp_path / "out.wav"
        w = WavWriter(inp, 44100, 1, 16, use_native=False)
        w.write(sig)
        w.close()
        rc = resample_wav.run([str(inp), str(outp), "-rate", "48000",
                               "-quality", "high", "-fast",
                               "-precision", "default"])
        assert rc == 0
        r = WavReader(outp, use_native=False)
        assert r.sample_rate == 48000
        r.close()


class TestWalkCapGuard:
    """The polyphase walk's int32 bound (cap < 2^15) shrinks the block;
    a plan whose cap exceeds it even at block=1 is refused with a clear
    error instead of halving the block to zero."""

    def _plan_with_step(self, step):
        import dataclasses
        plan = plan_engine(44100, 48001, Quality.HIGH)
        assert plan.kind == 'two_stage' and not plan.is_rational_exact
        return dataclasses.replace(plan, step=step)

    def test_unreachable_cap_raises_value_error(self):
        with pytest.raises(ValueError, match="int32 bound"):
            EngineCore(self._plan_with_step(1), batch=1, block=2048)

    def test_block_shrinks_until_cap_fits(self):
        plan = plan_engine(44100, 48001, Quality.HIGH)
        eng = EngineCore(plan, batch=1, block=1 << 16, dtype=np.float64)
        assert eng.poly_cap <= 32767
        assert 1 <= eng.block < 1 << 16
