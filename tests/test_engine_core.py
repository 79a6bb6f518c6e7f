"""Engine correctness vs the serial numpy oracle.

The oracle (tests/oracle.py) is a direct serial implementation of the
reference's streaming semantics; the device engine (static shapes, closed-form
phase walk, conv/gather/matmul kernels) must reproduce its sample stream
bit-tightly in float64.
"""

import numpy as np
import pytest

from go_audio_resampler_tpu.engine import (EngineCore, plan_engine, oneshot,
                                           EngineConfigError)
from go_audio_resampler_tpu.filterdesign import Quality

from oracle import oracle_oneshot

RNG = np.random.default_rng(42)


def signal(n, freq=997.0, rate=48000.0):
    t = np.arange(n) / rate
    return (np.sin(2 * np.pi * freq * t) * 0.9).astype(np.float64)


TOPOLOGIES = [
    # (in_rate, out_rate, quality, kind)
    (44100, 48000, Quality.HIGH, 'two_stage'),       # frac up, rational
    (48000, 44100, Quality.HIGH, 'two_stage'),       # frac down
    (44100, 48000, Quality.VERY_HIGH, 'two_stage'),
    (44100, 48000, Quality.LOW, 'two_stage'),
    (44100, 48000, Quality.MEDIUM, 'two_stage'),
    (48000, 96000, Quality.HIGH, 'dft_up'),          # integer up x2
    (48000, 192000, Quality.MEDIUM, 'dft_up'),       # integer up x4
    (96000, 48000, Quality.HIGH, 'decimate'),        # integer down x2
    (192000, 48000, Quality.MEDIUM, 'decimate'),     # integer down x4
    (48000, 32000, Quality.HIGH, 'two_stage'),       # 1.5x down
    (44100, 48000, Quality.QUICK, 'cubic'),
    (48000, 44100, Quality.QUICK, 'cubic'),
    (22050, 48000, Quality.HIGH, 'two_stage'),       # >2x frac up
    (48000, 11025, Quality.HIGH, 'two_stage'),       # >4x frac down
    # Non-exact-rational ratios: the streaming side runs the general
    # interpolated-coefficient walk (stages.poly_emit / walk16) instead of
    # the fused per-period matmul, so these rows are what value-checks
    # that code path against the oneshot oracle (whose host-side exact
    # walk is independent of it).
    (44100, 48001, Quality.HIGH, 'two_stage'),       # non-exact up
    (48000, 44099, Quality.HIGH, 'two_stage'),       # non-exact down
    (44100, 44101, Quality.MEDIUM, 'two_stage'),     # ratio 1+epsilon
]


class TestPlanTopology:
    @pytest.mark.parametrize("inr,outr,q,kind", TOPOLOGIES)
    def test_kind(self, inr, outr, q, kind):
        assert plan_engine(inr, outr, q).kind == kind

    def test_ratio_bounds(self):
        with pytest.raises(EngineConfigError):
            plan_engine(48000, 48000 / 300, Quality.HIGH)
        with pytest.raises(EngineConfigError):
            plan_engine(48000 / 300, 48000, Quality.HIGH)
        with pytest.raises(EngineConfigError):
            plan_engine(0, 48000, Quality.HIGH)
        with pytest.raises(EngineConfigError):
            plan_engine(float('nan'), 48000, Quality.HIGH)
        with pytest.raises(EngineConfigError):
            plan_engine(48000, float('inf'), Quality.HIGH)

    def test_cd_dat_structure(self):
        p = plan_engine(44100, 48000, Quality.HIGH)
        assert p.factor == 2 and p.pre_taps == 166
        assert p.num_phases == 80 and p.poly_taps == 64
        assert p.step == 147 * 65536
        assert p.is_rational_exact

    def test_length_model_matches_oracle(self):
        for inr, outr, q, _ in TOPOLOGIES:
            plan = plan_engine(inr, outr, q)
            for n in (1, 7, 100, 1000, 4097):
                expect = len(oracle_oneshot(plan, np.zeros(n)))
                assert plan.lengths.canonical(n) == expect, \
                    f"{inr}->{outr} q={q} n={n}"


class TestOneshotVsOracle:
    @pytest.mark.parametrize("inr,outr,q,kind", TOPOLOGIES)
    def test_matches_oracle(self, inr, outr, q, kind):
        plan = plan_engine(inr, outr, q)
        n = 2000
        x = signal(n, rate=inr)
        expect = oracle_oneshot(plan, x)
        got = np.asarray(oneshot(plan, x[None, :], dtype=np.float64))[0]
        assert got.shape == expect.shape, f"{got.shape} vs {expect.shape}"
        np.testing.assert_allclose(got, expect, rtol=1e-9, atol=1e-12)

    def test_batched_streams_independent(self):
        plan = plan_engine(44100, 48000, Quality.HIGH)
        xs = np.stack([signal(1500, f) for f in (440.0, 997.0, 5000.0)])
        batched = np.asarray(oneshot(plan, xs, dtype=np.float64))
        for i in range(3):
            single = np.asarray(oneshot(plan, xs[i:i + 1], dtype=np.float64))[0]
            np.testing.assert_allclose(batched[i], single, rtol=1e-12, atol=1e-15)

    def test_empty_input(self):
        plan = plan_engine(44100, 48000, Quality.HIGH)
        y = np.asarray(oneshot(plan, np.zeros((1, 0)), dtype=np.float64))
        assert y.shape[1] == 0

    def test_dc_gain(self):
        # DC input resamples to DC of the same level (steady state)
        for inr, outr, q, _ in [(44100, 48000, Quality.HIGH, None),
                                (96000, 48000, Quality.HIGH, None),
                                (48000, 96000, Quality.HIGH, None)]:
            plan = plan_engine(inr, outr, q)
            x = np.ones((1, 4000))
            y = np.asarray(oneshot(plan, x, dtype=np.float64))[0]
            mid = y[len(y) // 3: 2 * len(y) // 3]
            assert abs(mid.mean() - 1.0) < 1e-3, f"{inr}->{outr}"
            assert abs(mid - 1.0).max() < 1e-2

    def test_float32_close_to_float64(self):
        plan = plan_engine(44100, 48000, Quality.HIGH)
        x = signal(3000, rate=44100)
        y64 = np.asarray(oneshot(plan, x[None], dtype=np.float64))[0]
        y32 = np.asarray(oneshot(plan, x[None].astype(np.float32),
                                 dtype=np.float32))[0]
        assert y32.shape == y64.shape
        np.testing.assert_allclose(y32, y64, atol=5e-5)


class TestStreamingVsOneshot:
    @pytest.mark.parametrize("inr,outr,q,kind", TOPOLOGIES)
    def test_single_chunk(self, inr, outr, q, kind):
        plan = plan_engine(inr, outr, q)
        n = 3000
        x = signal(n, rate=inr)
        expect = np.asarray(oneshot(plan, x[None], dtype=np.float64))[0]
        eng = EngineCore(plan, batch=1, block=512, dtype=np.float64)
        got = np.concatenate([eng.process(x)[0], eng.flush()[0]])
        assert got.shape == expect.shape
        np.testing.assert_allclose(got, expect, rtol=1e-9, atol=1e-12)

    @pytest.mark.parametrize("chunks", [
        [3000],
        [1, 2999],
        [100] * 30,
        [1, 511, 512, 1024, 952],
        [7, 13, 280, 2700],
    ])
    def test_chunking_invariance(self, chunks):
        # SURVEY.md section 4.4: arbitrary chunk sizes -> identical stream
        plan = plan_engine(44100, 48000, Quality.HIGH)
        n = sum(chunks)
        x = signal(n, rate=44100)
        expect = np.asarray(oneshot(plan, x[None], dtype=np.float64))[0]
        eng = EngineCore(plan, batch=1, block=512, dtype=np.float64)
        outs = []
        off = 0
        for c in chunks:
            outs.append(eng.process(x[off:off + c])[0])
            off += c
        outs.append(eng.flush()[0])
        got = np.concatenate(outs)
        np.testing.assert_allclose(got, expect, rtol=1e-9, atol=1e-12)

    def test_block_size_invariance(self):
        plan = plan_engine(48000, 44100, Quality.HIGH)
        x = signal(2500, rate=48000)
        ref = None
        for block in (128, 600, 2048):
            eng = EngineCore(plan, batch=1, block=block, dtype=np.float64)
            got = np.concatenate([eng.process(x)[0], eng.flush()[0]])
            if ref is None:
                ref = got
            else:
                np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)

    @pytest.mark.parametrize("inr,outr,q,kind", TOPOLOGIES)
    def test_scan_multiblock_path(self, inr, outr, q, kind):
        # A single large process() call takes the lax.scan multi-block
        # launch (EngineCore.SCAN_BLOCKS); stream must stay canonical.
        plan = plan_engine(inr, outr, q)
        n = 6000   # > SCAN_BLOCKS * block -> scan path + remainder + flush
        x = signal(n, rate=inr)
        expect = np.asarray(oneshot(plan, x[None], dtype=np.float64))[0]
        eng = EngineCore(plan, batch=1, block=512, dtype=np.float64)
        got = np.concatenate([eng.process(x)[0], eng.flush()[0]])
        assert got.shape == expect.shape
        np.testing.assert_allclose(got, expect, rtol=1e-9, atol=1e-12)

    def test_reset_reproducible(self):
        plan = plan_engine(44100, 48000, Quality.HIGH)
        x = signal(1000, rate=44100)
        eng = EngineCore(plan, batch=1, block=256, dtype=np.float64)
        a = np.concatenate([eng.process(x)[0], eng.flush()[0]])
        eng.reset()
        b = np.concatenate([eng.process(x)[0], eng.flush()[0]])
        np.testing.assert_array_equal(a, b)

    def test_statistics(self):
        plan = plan_engine(44100, 48000, Quality.HIGH)
        x = signal(1000, rate=44100)
        eng = EngineCore(plan, batch=1, block=256, dtype=np.float64)
        eng.process(x)
        eng.flush()
        stats = eng.get_statistics()
        assert stats["samplesIn"] == 1000
        assert stats["samplesOut"] == plan.lengths.canonical(1000)

    def test_batch_streaming(self):
        plan = plan_engine(96000, 48000, Quality.HIGH)
        xs = np.stack([signal(2000, f, 96000) for f in (500.0, 3000.0)])
        eng = EngineCore(plan, batch=2, block=512, dtype=np.float64)
        got = np.concatenate([eng.process(xs), eng.flush()], axis=1)
        expect = np.asarray(oneshot(plan, xs, dtype=np.float64))
        np.testing.assert_allclose(got, expect, rtol=1e-9, atol=1e-12)

    def test_estimate_output_upper_bound(self):
        # constant.go:117-119 contract: estimate is a true upper bound
        for inr, outr, q, _ in TOPOLOGIES:
            plan = plan_engine(inr, outr, q)
            for n in (1, 100, 1000, 4096):
                assert plan.lengths.canonical(n) <= plan.estimate_output(n), \
                    f"{inr}->{outr} n={n}"


class TestMatrixCache:
    """The host-side banded-matrix cache is fingerprint-keyed and bounded."""

    def test_cache_lru_byte_bound(self):
        import importlib
        os_mod = importlib.import_module(
            'go_audio_resampler_tpu.engine.oneshot')
        plan = plan_engine(44100, 48001, Quality.HIGH)  # non-exact rational
        assert plan.kind == 'two_stage' and not plan.is_rational_exact
        saved_limit = os_mod.GENERAL_CACHE_LIMIT
        saved_cache = dict(os_mod._GENERAL_CACHE)
        try:
            os_mod._GENERAL_CACHE.clear()
            os_mod._GENERAL_CACHE_BYTES = 0
            one = os_mod._general_matrices(plan, 2048)
            entry_bytes = sum(a.nbytes for a in one)
            # Cap at ~2 entries; inserting 5 distinct lengths must evict.
            os_mod.GENERAL_CACHE_LIMIT = int(2.5 * entry_bytes)
            os_mod._GENERAL_CACHE.clear()
            os_mod._GENERAL_CACHE_BYTES = 0
            for count in (2048, 2304, 2560, 2816, 3072):
                os_mod._general_matrices(plan, count)
            assert len(os_mod._GENERAL_CACHE) <= 3
            assert os_mod._GENERAL_CACHE_BYTES <= os_mod.GENERAL_CACHE_LIMIT
            # Most-recent entry survives (LRU semantics).
            assert (plan.fingerprint, 3072, os_mod.GENERAL_TILE) \
                in os_mod._GENERAL_CACHE
        finally:
            os_mod.GENERAL_CACHE_LIMIT = saved_limit
            os_mod._GENERAL_CACHE.clear()
            os_mod._GENERAL_CACHE.update(saved_cache)
            os_mod._GENERAL_CACHE_BYTES = sum(
                sum(a.nbytes for a in v) for v in saved_cache.values())

    def test_cache_key_is_plan_fingerprint_not_id(self):
        import importlib
        os_mod = importlib.import_module(
            'go_audio_resampler_tpu.engine.oneshot')
        p1 = plan_engine(44100, 48001, Quality.HIGH)
        m1 = os_mod._general_matrices(p1, 2048)
        plan_engine.cache_clear()
        p2 = plan_engine(44100, 48001, Quality.HIGH)
        assert p1 is not p2  # fresh object, same configuration
        m2 = os_mod._general_matrices(p2, 2048)
        assert m1[1] is m2[1]  # same cached matrices via fingerprint


class TestBandedEmitParity:
    """The GPU banded-tile polyphase emit (stages._poly_emit_banded) must
    equal the per-output gather path up to float32 summation order.

    The lowering itself is backend-gated (GPU float32 only); here it is
    invoked directly so the algebra is verified in CI, and the hardware
    numerics are covered by chip_smoke.py / tools/quality_device.py.
    """

    @pytest.mark.parametrize("inr,outr", [
        (44100, 48001),      # non-exact fractional up
        (48000, 44100),      # fractional down
        (96000, 44100),      # deep fractional down (largest step)
        (44100, 44101),      # near-unity walk
    ])
    def test_matches_gather_path(self, inr, outr):
        import jax.numpy as jnp
        from go_audio_resampler_tpu.engine import stages

        plan = plan_engine(float(inr), float(outr), Quality.HIGH)
        assert plan.kind in ('two_stage', 'poly')
        L, T = plan.num_phases, plan.poly_taps
        q, s_lo = plan.step_hi, plan.step_lo
        rng = np.random.default_rng(3)
        S, HW, cap = 3, 4096, 512
        hist = jnp.asarray(rng.normal(size=(S, HW)).astype(np.float32))
        hist_len = jnp.int32(HW - 64)
        banks = tuple(jnp.asarray(b, jnp.float32) for b in
                      (plan.bank_a, plan.bank_b, plan.bank_c, plan.bank_d))
        at_hi, at_lo = jnp.int32(37), jnp.int32(1234)
        y0, v0, n0, _, _ = stages.poly_emit(
            banks, hist, hist_len, at_hi, at_lo, L, T, q, s_lo, cap)
        hi, frac = stages.walk16(at_hi, at_lo, q, s_lo, cap)
        div = hi // L
        phase = hi - div * L
        x = frac.astype(hist.dtype) * (1.0 / 65536.0)
        tv = stages.POLY_EMIT_TILE
        pad = -cap % tv
        div_adv = ((tv - 1) * (q + 1)) // L + 1
        span = -(-(div_adv + T) // 128) * 128
        y1 = stages._poly_emit_banded(
            banks, hist,
            jnp.pad(div, (0, pad), mode='edge'),
            jnp.pad(phase, (0, pad), mode='edge'),
            jnp.pad(x, (0, pad), mode='edge'), T, span, tv)[:, :cap]
        y1 = y1 * v0.astype(y1.dtype)[None, :]
        assert float(jnp.abs(y1 - y0).max()) < 1e-5
