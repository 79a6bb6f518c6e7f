"""Buffer-integrity tier: outputs are independent of later activity.

Reference anchor: internal/engine/buffer_integrity_test.go:18-400 — the
reference asserts that a slice returned by Process is never corrupted by
later Process/Flush calls, that mutating the caller's input after the
call does not retroactively change outputs, and that mutating a returned
buffer does not poison subsequent outputs.  The device build's contract is
stronger (every emission is a fresh host download), but nothing enforced
it until this tier.
"""
from __future__ import annotations

import numpy as np
import pytest

import go_audio_resampler_tpu as gar
from go_audio_resampler_tpu.engine import EngineCore, plan_engine
from go_audio_resampler_tpu.filterdesign import Quality

RNG = np.random.default_rng(0xB0FFE12)


def _collect(eng, chunks):
    outs = []
    for c in chunks:
        y = eng.process(c)
        outs.append((y, y.copy()))
    tail = eng.flush()
    outs.append((tail, tail.copy()))
    return outs


def _assert_stable(outs):
    for y, snap in outs:
        np.testing.assert_array_equal(np.asarray(y), snap)


# (in_rate, out_rate, quality) covering every step-kernel family:
# fused rational (44.1k->48k), integer decimation (96k->48k), dft_up
# (48k->96k), cubic (QUICK), and a strict-antialias prefilter path.
ENGINE_CASES = [
    (44100.0, 48000.0, Quality.HIGH),
    (96000.0, 48000.0, Quality.HIGH),
    (48000.0, 96000.0, Quality.HIGH),
    (44100.0, 48000.0, Quality.QUICK),
]


class TestEngineOutputsStable:
    @pytest.mark.parametrize("inr,outr,q", ENGINE_CASES)
    def test_later_calls_do_not_corrupt_earlier_outputs(self, inr, outr, q):
        plan = plan_engine(inr, outr, q)
        eng = EngineCore(plan, batch=2, block=512, dtype=np.float64)
        chunks = [RNG.normal(size=(2, 700)) * 0.5 for _ in range(4)]
        outs = _collect(eng, chunks)
        _assert_stable(outs)

    @pytest.mark.parametrize("inr,outr,q", ENGINE_CASES[:2])
    def test_mutating_input_after_call_is_safe(self, inr, outr, q):
        plan = plan_engine(inr, outr, q)
        eng = EngineCore(plan, batch=1, block=512, dtype=np.float64)
        x = RNG.normal(size=(1, 3000)) * 0.5
        x_orig = x.copy()
        y1 = eng.process(x)
        snap1 = y1.copy()
        x[:] = 99.0                     # caller reuses its input buffer
        y2 = eng.process(np.zeros((1, 1500)))
        tail = eng.flush()
        np.testing.assert_array_equal(y1, snap1)
        # replay with a pristine input: the stream must be identical,
        # proving the engine did not hold a reference into the caller's
        # mutated buffer for deferred work (FIFO holdback, aa carry).
        eng2 = EngineCore(plan, batch=1, block=512, dtype=np.float64)
        z1 = eng2.process(x_orig)
        z2 = eng2.process(np.zeros((1, 1500)))
        ztail = eng2.flush()
        np.testing.assert_array_equal(
            np.concatenate([snap1, y2, tail], axis=1),
            np.concatenate([z1, z2, ztail], axis=1))

    def test_mutating_returned_buffer_is_safe(self):
        plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
        eng = EngineCore(plan, batch=1, block=512, dtype=np.float64)
        x = RNG.normal(size=(1, 2000)) * 0.5
        y1 = eng.process(x)
        y1[:] = -123.0                  # caller scribbles on the output
        y2 = eng.process(x)
        tail = eng.flush()
        eng2 = EngineCore(plan, batch=1, block=512, dtype=np.float64)
        z1 = eng2.process(x)
        z2 = eng2.process(x)
        ztail = eng2.flush()
        np.testing.assert_array_equal(y2, z2)
        np.testing.assert_array_equal(tail, ztail)


class TestResamplerOutputsStable:
    """Public-API tier: multi-stage pipeline (fused and per-stage) and
    strict-antialias paths return self-contained buffers."""

    @pytest.mark.parametrize("outr", [8000.0, 8000.1])
    def test_pipeline_outputs_stable(self, outr):
        cfg = gar.Config(48000, outr, channels=2, max_input_size=2048,
                         quality=gar.QualitySpec(preset=gar.QualityPreset.HIGH),
                         dtype=np.float64)
        r = gar.new_resampler(cfg)
        chunks = [[RNG.normal(size=1500) * 0.5 for _ in range(2)]
                  for _ in range(3)]
        outs = []
        for c in chunks:
            ys = r.process_multi(c)
            outs.extend((y, np.array(y, copy=True)) for y in ys)
        tails = r.flush_multi()
        outs.extend((t, np.array(t, copy=True)) for t in tails)
        _assert_stable(outs)

    def test_strict_antialias_input_mutation_safe(self):
        cfg = gar.Config(44100, 48000, channels=1, max_input_size=2048,
                         quality=gar.QualitySpec(preset=gar.QualityPreset.HIGH),
                         strict_antialias=True,
                         dtype=np.float64)
        x = RNG.normal(size=4000) * 0.5
        x_orig = x.copy()
        r = gar.new_resampler(cfg)
        y1 = np.array(r.process(x), copy=True)
        x[:] = 7.0
        y2 = r.process(np.zeros(2000))
        tail = r.flush()
        r2 = gar.new_resampler(cfg)
        z1 = r2.process(x_orig)
        z2 = r2.process(np.zeros(2000))
        ztail = r2.flush()
        np.testing.assert_array_equal(
            np.concatenate([y1, y2, tail]),
            np.concatenate([z1, z2, ztail]))
