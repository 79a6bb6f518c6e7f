"""Roofline accounting (utils/roofline.py).

CD->DAT HIGH's fused matrix is [160, 343] over Ipx=147: 2*160*343/147
~ 747 flop per input sample, and the XLA lowering's materialized frames
move 4*(343/147 + 160/147) ~ 13.7 B per input sample — about 55 flop/B,
above the H200's float32 ridge of 67e12/4.8e12 ~ 14 flop/B.
"""

import numpy as np
import pytest

from go_audio_resampler_tpu.utils.roofline import (
    PEAKS, TIER_UNIT, analyze, banded_model, device_peaks, general_model)

H200 = {"kind": "NVIDIA H200", **PEAKS["NVIDIA H200"]}


class TestBandedModel:
    def test_cd_dat_dims(self):
        m = banded_model(160, 343, 147)
        assert m["flops_per_in"] == pytest.approx(2 * 160 * 343 / 147)
        # XLA materializes overlapping frames: wx/ipx reads of x plus
        # P2/Ipx output samples, f32.
        assert m["bytes_per_in"] == pytest.approx(4 * (343 / 147 + 160 / 147))
        assert m["flops_per_in"] / m["bytes_per_in"] == pytest.approx(
            54.6, abs=0.5)

    def test_explicit_read_amp(self):
        m = banded_model(160, 343, 147, read_amp=1.0)
        assert m["bytes_per_in"] == pytest.approx(4 * (1.0 + 160 / 147))

    def test_matches_live_plan(self):
        from go_audio_resampler_tpu.engine import plan_engine
        from go_audio_resampler_tpu.engine.oneshot import (
            _fused_rational_matrix, superframe)
        from go_audio_resampler_tpu.filterdesign import Quality

        plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
        r, p2, ipx, _lam = _fused_rational_matrix(plan)
        rs, ipxs = superframe(r, ipx)
        m = banded_model(rs.shape[0], rs.shape[1], ipxs,
                         nnz=int(np.count_nonzero(rs)))
        assert (m["p2"], m["wx"], m["ipx"]) == (160, 343, 147.0)
        # The matrix is ~57% dense; the nnz accounting must sit below
        # the dense flops.
        assert m["nnz_flops_per_in"] < m["flops_per_in"]
        assert m["nnz_flops_per_in"] / m["flops_per_in"] == pytest.approx(
            0.57, abs=0.02)

    def test_fractional_ipx(self):
        m = banded_model(256, 512, 256 * 44100 / 48001)
        assert m["flops_per_in"] == pytest.approx(
            2 * 256 * 512 / (256 * 44100 / 48001))

    def test_general_model_counts(self):
        m = general_model(factor=2, pre_taps=100, poly_taps=20,
                          num_phases=64, step_hi=100, block=2048,
                          poly_cap=3000)
        outs_per_in = 3072 / 2048
        assert m["bytes_per_in"] == pytest.approx(
            4.0 * (1.0 + 4.0 + outs_per_in))
        assert m["flops_per_in"] > 2.0 * 2 * 100


class TestAnalyze:
    def test_cd_dat_highest_is_compute_bound(self):
        # At the float32 tier the step's ~55 flop/B sits above the ridge:
        # operations, not bytes, set its least time.
        m = banded_model(160, 343, 147)
        a = analyze(40000.0, m, tier="highest", peaks=H200)
        assert a["unit"] == "fp32"
        assert a["bound"] == "compute"
        assert a["tflops_achieved"] == pytest.approx(
            40000e6 * 2 * 160 * 343 / 147 / 1e12)
        assert a["flops_pct"] == pytest.approx(
            100 * a["tflops_achieved"] / 67.0)
        assert a["roofline_pct"] == pytest.approx(a["flops_pct"])

    def test_tf32_tier_is_memory_bound(self):
        # TF32's ridge is 495e12/4.8e12 ~ 103 flop/B: the same step is
        # then bounded by its bytes.
        m = banded_model(160, 343, 147)
        a = analyze(40000.0, m, tier="high", peaks=H200)
        assert a["unit"] == "tf32"
        assert a["bound"] == "memory"
        assert a["roofline_pct"] == pytest.approx(a["hbm_pct"])

    def test_hbm_numbers(self):
        m = banded_model(160, 343, 147)
        a = analyze(100000.0, m, tier="highest", peaks=H200)
        assert a["hbm_gbps"] == pytest.approx(
            100000e6 * m["bytes_per_in"] / 1e9)
        assert a["hbm_pct"] == pytest.approx(100 * a["hbm_gbps"] / 4800.0)

    @pytest.mark.parametrize("tier", sorted(TIER_UNIT))
    def test_every_tier_has_a_unit(self, tier):
        assert TIER_UNIT[tier] in PEAKS["NVIDIA H200"]
        a = analyze(1000.0, banded_model(160, 343, 147), tier=tier,
                    peaks=H200)
        assert a["bound"] in ("compute", "memory")


class TestDevicePeaks:
    def test_h200_known(self):
        class Fake:
            device_kind = "NVIDIA H200"

        p = device_peaks(device=Fake())
        assert p["kind"] == "NVIDIA H200"
        assert (p["fp32"], p["tf32"], p["bf16"], p["hbm_gbps"]) == (
            67.0, 495.0, 989.0, 4800.0)

    @pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                      "NVIDIA H100 80GB HBM3"])
    def test_unknown_device_raises(self, kind):
        class Fake:
            device_kind = kind

        with pytest.raises(ValueError, match="no published peaks"):
            device_peaks(device=Fake())

    def test_default_device_on_cpu_raises(self):
        # The test suite runs on the CPU, which has no entry: the default
        # device must be refused, not mapped to some accelerator's peaks.
        with pytest.raises(ValueError):
            device_peaks()
