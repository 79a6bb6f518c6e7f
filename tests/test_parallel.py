"""Multi-device sharding tests on the virtual 8-device CPU mesh.

Validates the stream-axis data-parallel scaling model (SURVEY.md
section 2's device mapping of goroutine-per-channel parallelism) and
the driver entry points.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from go_audio_resampler_tpu.engine import plan_engine, oneshot
from go_audio_resampler_tpu import parallel
from go_audio_resampler_tpu.filterdesign import Quality


@pytest.fixture(scope="module")
def mesh():
    return parallel.make_mesh(8)


class TestShardedOneshot:
    def test_matches_single_device(self, mesh):
        plan = plan_engine(44100, 48000, Quality.HIGH)
        x = np.random.default_rng(0).normal(size=(16, 1500)).astype(np.float32)
        y_sharded = np.asarray(parallel.sharded_oneshot(plan, x, mesh))
        y_single = np.asarray(oneshot(plan, x, dtype=np.float32))
        np.testing.assert_allclose(y_sharded, y_single, atol=1e-5)

    def test_sharding_layout(self, mesh):
        plan = plan_engine(44100, 48000, Quality.HIGH)
        x = np.zeros((8, 441), np.float32)
        y = parallel.sharded_oneshot(plan, x, mesh)
        # output stays sharded over the stream axis (no gather to host)
        assert len(y.sharding.device_set) == 8


class TestGlobalStats:
    def test_psum_rms_and_pmax_peak(self, mesh):
        x = np.random.default_rng(1).normal(size=(16, 256)).astype(np.float32)
        rms, peak = parallel.global_stream_stats(x, mesh)
        assert float(rms) == pytest.approx(float(x.std()), rel=1e-4)
        assert float(peak) == pytest.approx(float(np.abs(x).max()), rel=1e-6)


class TestShardedStreaming:
    def test_step_carries_state(self, mesh):
        plan = plan_engine(44100, 48000, Quality.HIGH)
        init, step, blk = parallel.sharded_stream_step(plan, mesh,
                                                       batch_per_device=1,
                                                       block=128)
        state = init()
        x = jnp.asarray(np.random.default_rng(2).normal(
            size=(8, blk)).astype(np.float32))
        outs = []
        ns = []
        for _ in range(4):
            state, y, n, peak = step(state, x)
            outs.append(np.asarray(y)[:, :int(n)])
            ns.append(int(n))
        got = np.concatenate(outs, axis=1)
        # The fused step's stream is the canonical stream preceded by the
        # convolution-ramp prefix; drop it and compare lane-for-lane.
        from go_audio_resampler_tpu.engine.oneshot import (
            _fused_rational_matrix, superframe)
        r, p2_, ipx, lam = _fused_rational_matrix(plan)
        r, ipx = superframe(r, ipx, kf_cap=max(1, 128 // ipx))
        p2_ = r.shape[0]
        carry_len = lam + -(-max(r.shape[1] - ipx - lam, 0) // ipx) * ipx
        drop = ((carry_len - lam) // ipx) * p2_
        got = got[:, drop:]
        xfull = np.tile(np.asarray(x), (1, 4))
        ref = np.asarray(oneshot(plan, xfull, dtype=np.float32))
        m = min(ref.shape[1], got.shape[1])
        assert m > 200
        np.testing.assert_allclose(got[:, :m], ref[:, :m], atol=1e-5)


class TestShardedStreamingGeneralPath:
    def test_high_ratio_block_clamped_and_matches_serial(self, mesh):
        # ADVICE r1 (medium): the general poly-walk sharded step must clamp
        # its block so the walk16 cap stays < 2^15 (int32 safety), same as
        # EngineCore._build_constants.
        from go_audio_resampler_tpu.engine import EngineCore
        plan = plan_engine(1000.0, 199500.0, Quality.LOW)
        assert plan.kind == 'two_stage' and not plan.is_rational_exact
        init, step, blk = parallel.sharded_stream_step(
            plan, mesh, batch_per_device=1, block=2048)
        m = blk * plan.factor
        cap = -(-m * plan.num_phases * 65536 // plan.step) + 1
        assert cap <= 32767
        rng = np.random.default_rng(3)
        x = rng.normal(size=(8, 2 * blk)).astype(np.float32)
        state = init()
        outs = []
        for i in range(2):
            state, y, n, peak = step(
                state, jnp.asarray(x[:, i * blk:(i + 1) * blk]))
            outs.append(np.asarray(y)[:, :int(n)])
        got = np.concatenate(outs, axis=1)[:, plan.lengths.drop_prefix():]
        eng = EngineCore(plan, batch=8, block=blk, dtype=np.float32)
        ref = eng.process(x)
        m2 = min(got.shape[1], ref.shape[1])
        assert m2 > 100
        np.testing.assert_allclose(got[:, :m2], ref[:, :m2], atol=2e-4)


class TestShardedEngineCore:
    """Full sharded streaming engine: every topology must reproduce the
    serial EngineCore's stream (VERDICT r1 item 5)."""

    CASES = [
        (44100, 48000, Quality.HIGH, False),    # two_stage exact-rational
        (48000, 44100, Quality.HIGH, False),    # two_stage frac-down
        (48000, 96000, Quality.HIGH, False),    # dft_up
        (96000, 48000, Quality.HIGH, False),    # decimate
        (44100, 48000, Quality.QUICK, False),   # cubic
        (1000, 199500, Quality.LOW, False),     # general path (clamped)
        (48000, 44100, Quality.HIGH, True),     # strict-aa prefilter
    ]

    @pytest.mark.parametrize("inr,outr,q,strict", CASES)
    def test_matches_serial_engine(self, mesh, inr, outr, q, strict):
        from go_audio_resampler_tpu.engine import EngineCore
        plan = plan_engine(inr, outr, q, strict)
        x = np.random.default_rng(11).standard_normal((8, 3000))
        sharded = parallel.ShardedEngineCore(plan, mesh, batch_per_device=1,
                                             block=512, dtype=np.float64)
        got = np.concatenate([sharded.process(x), sharded.flush()], axis=1)
        serial = EngineCore(plan, batch=8, block=512, dtype=np.float64)
        ref = np.concatenate([serial.process(x), serial.flush()], axis=1)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)

    def test_chunked_streaming_and_reset(self, mesh):
        from go_audio_resampler_tpu.engine import EngineCore
        plan = plan_engine(44100, 48000, Quality.HIGH)
        x = np.random.default_rng(12).standard_normal((8, 2500))
        sharded = parallel.ShardedEngineCore(plan, mesh, batch_per_device=1,
                                             block=512, dtype=np.float64)
        got = np.concatenate([sharded.process(x[:, :700]),
                              sharded.process(x[:, 700:703]),
                              sharded.process(x[:, 703:]),
                              sharded.flush()], axis=1)
        serial = EngineCore(plan, batch=8, block=512, dtype=np.float64)
        ref = np.concatenate([serial.process(x), serial.flush()], axis=1)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
        sharded.reset()
        again = np.concatenate([sharded.process(x), sharded.flush()], axis=1)
        np.testing.assert_allclose(again, ref, rtol=0, atol=1e-12)

    def test_scan_multiblock_path(self, mesh):
        # one large call (> SCAN_BLOCKS * block) takes the sharded
        # lax.scan multi-block launch
        from go_audio_resampler_tpu.engine import EngineCore
        plan = plan_engine(44100, 48000, Quality.HIGH)
        x = np.random.default_rng(13).standard_normal((8, 9000))
        sharded = parallel.ShardedEngineCore(plan, mesh, batch_per_device=1,
                                             block=512, dtype=np.float64)
        got = np.concatenate([sharded.process(x), sharded.flush()], axis=1)
        serial = EngineCore(plan, batch=8, block=512, dtype=np.float64)
        ref = np.concatenate([serial.process(x), serial.flush()], axis=1)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)

    def test_state_stays_sharded(self, mesh):
        plan = plan_engine(44100, 48000, Quality.HIGH)
        sharded = parallel.ShardedEngineCore(plan, mesh, batch_per_device=1,
                                             block=512, dtype=np.float64)
        sharded.process(np.zeros((8, 512)))
        leaves = jax.tree_util.tree_leaves(sharded.state)
        wide = [l for l in leaves if getattr(l, 'ndim', 0) >= 2]
        assert wide and all(len(l.sharding.device_set) == 8 for l in wide)


class TestGraftEntry:
    def test_entry_compiles(self):
        import __graft_entry__ as ge
        fn, args = ge.entry()
        y = jax.jit(fn)(*args)
        assert y.shape[0] == args[0].shape[0]

    def test_dryrun_multichip(self):
        import __graft_entry__ as ge
        ge.dryrun_multichip(8)


class TestShardedVariableRate:
    def test_sharded_matches_serial(self):
        from go_audio_resampler_tpu import parallel
        from go_audio_resampler_tpu.engine.variable import (
            VariableRateResampler)
        mesh = parallel.make_mesh()
        rng = np.random.default_rng(12)
        s = 2 * mesh.devices.size
        x = rng.normal(size=(s, 6000))
        sh = parallel.ShardedVariableRateResampler(
            2.0, 0.9, mesh=mesh, batch_per_device=2,
            dtype=np.float64, block=1024)
        sh.set_io_ratio(1.1, slew_len=2000)
        ser = VariableRateResampler(2.0, 0.9, batch=s,
                                    dtype=np.float64, block=1024)
        ser.set_io_ratio(1.1, slew_len=2000)
        ys = np.concatenate([sh.process(x), sh.flush()], axis=1)
        yr = np.concatenate([ser.process(x), ser.flush()], axis=1)
        assert ys.shape == yr.shape
        np.testing.assert_allclose(ys, yr, rtol=1e-13, atol=2e-15)


class TestShardedDeviceMode:
    """Device-resident serving on the sharded engine: process_device /
    flush_device inherit through EngineCore and must (a) match the
    serial stream and (b) keep the outputs sharded on the stream axis —
    the multi-chip zero-sync serving path."""

    def test_matches_serial_and_stays_sharded(self, mesh):
        from go_audio_resampler_tpu.engine import EngineCore
        plan = plan_engine(44100, 48000, Quality.HIGH)
        sharded = parallel.ShardedEngineCore(plan, mesh, batch_per_device=1,
                                             block=512, dtype=np.float64)
        mult = sharded.device_chunk_multiple
        assert mult is not None
        x = np.random.default_rng(21).standard_normal((8, 6 * mult))
        y1 = sharded.process_device(jnp.asarray(x))
        y2 = sharded.flush_device()
        assert isinstance(y1, jax.Array) and isinstance(y2, jax.Array)
        assert len(y1.sharding.device_set) == 8
        got = np.concatenate([np.asarray(y1), np.asarray(y2)], axis=1)
        serial = EngineCore(plan, batch=8, block=512, dtype=np.float64)
        ref = np.concatenate([serial.process(x), serial.flush()], axis=1)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-13)

    def test_banded_composite_device_mode(self, mesh):
        from go_audio_resampler_tpu.engine import EngineCore
        from go_audio_resampler_tpu.pipeline.fused import (BandedPlan,
                                                           fuse_chain)
        plans = [plan_engine(48000, 24000, Quality.HIGH),
                 plan_engine(24000, 22050, Quality.HIGH, True)]
        op = fuse_chain(plans)
        assert op is not None and op.n_head > 0
        bplan = BandedPlan(op, ratio=22050.0 / 48000.0)
        sharded = parallel.ShardedEngineCore(bplan, mesh,
                                             batch_per_device=1,
                                             block=512, dtype=np.float64)
        mult = sharded.device_chunk_multiple
        x = np.random.default_rng(22).standard_normal((8, 4 * mult))
        got = np.concatenate(
            [np.asarray(sharded.process_device(jnp.asarray(x))),
             np.asarray(sharded.flush_device())], axis=1)
        serial = EngineCore(bplan, batch=8, block=512, dtype=np.float64)
        ref = np.concatenate([serial.process(x), serial.flush()], axis=1)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-13)


class TestShardedPipelinedStream:
    """The pipelined stream() generator inherits through
    ShardedEngineCore: ragged host chunks, sharded device launches, and
    the same canonical stream as the serial engine."""

    def test_stream_matches_serial(self, mesh):
        from go_audio_resampler_tpu.engine import EngineCore
        plan = plan_engine(44100, 48000, Quality.HIGH)
        sharded = parallel.ShardedEngineCore(plan, mesh, batch_per_device=1,
                                             block=512, dtype=np.float64)
        x = np.random.default_rng(29).standard_normal((8, 5000))
        got = np.concatenate(
            list(sharded.stream([x[:, :1777], x[:, 1777:]])), axis=1)
        serial = EngineCore(plan, batch=8, block=512, dtype=np.float64)
        ref = np.concatenate([serial.process(x), serial.flush()], axis=1)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-13)

    def test_stream_device_out_stays_sharded(self, mesh):
        plan = plan_engine(44100, 48000, Quality.HIGH)
        sharded = parallel.ShardedEngineCore(plan, mesh, batch_per_device=1,
                                             block=512, dtype=np.float64)
        mult = sharded.device_chunk_multiple
        x = np.random.default_rng(31).standard_normal((8, 8 * mult))
        outs = list(sharded.stream([x], out='device'))
        assert all(isinstance(o, jax.Array) for o in outs)
        big = [o for o in outs if o.shape[1] > 8]
        assert big and all(len(o.sharding.device_set) == 8 for o in big)


class TestShardedVRDeviceMode:
    """VR device mode inherits through ShardedVariableRateResampler:
    outputs stay sharded, parity with the serial VR engine mid-slew."""

    def test_sharded_vr_device_matches_serial(self, mesh):
        from go_audio_resampler_tpu.engine.variable import (
            VariableRateResampler)
        rng = np.random.default_rng(53)
        x = rng.standard_normal((8, 4 * 1024)) * 0.5

        serial = VariableRateResampler(2.0, 0.9, batch=8, block=1024,
                                       dtype=np.float64)
        serial.set_io_ratio(1.2, slew_len=1500)
        ref = np.concatenate([serial.process(x), serial.flush()], axis=1)

        sh = parallel.ShardedVariableRateResampler(
            2.0, 0.9, mesh=mesh, batch_per_device=1, block=1024,
            dtype=np.float64)
        sh.set_io_ratio(1.2, slew_len=1500)
        y = sh.process_device(jnp.asarray(x))
        t = sh.flush_device()
        assert isinstance(y, jax.Array)
        assert len(y.sharding.device_set) == 8
        got = np.concatenate([np.asarray(y), np.asarray(t)], axis=1)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-13)
