"""Banded frames lowerings against a dense float64 reference.

The serving step (``streaming._banded_frames_apply``) and the one-shot
general/cubic core (``oneshot._banded_tiles_apply``) are XLA gather +
einsum programs.  Here each is checked against an independent numpy
float64 construction of the same banded operator, at the shapes the
serving path uses (CD->DAT, odd periods, short streaming blocks,
superframed and decimating geometries).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from go_audio_resampler_tpu.engine import plan_engine
from go_audio_resampler_tpu.engine import streaming as strm
from go_audio_resampler_tpu.engine.oneshot import (_banded_tiles_apply,
                                                   _fused_rational_matrix)
from go_audio_resampler_tpu.filterdesign import Quality


def reference(x, R, Ipx, nf):
    wx = R.shape[1]
    xp = np.pad(x, ((0, 0), (0, wx)))
    frames = np.stack([xp[:, m * Ipx:m * Ipx + wx] for m in range(nf)], axis=1)
    return np.einsum('sfw,pw->sfp', frames.astype(np.float64),
                     R).reshape(x.shape[0], nf * R.shape[0])


def frames_apply(x, R, ipx, n_frames):
    """The serving step's lowering in float32 on [S, n] input."""
    return np.asarray(strm._banded_frames_apply(
        jnp.asarray(x, jnp.float32), jnp.asarray(R.T, jnp.float32),
        ipx, R.shape[1], R.shape[0], n_frames))


class TestFramesApply:
    def test_cd_dat_matches_reference(self):
        plan = plan_engine(44100, 48000, Quality.HIGH)
        R, P2, Ipx, _lam = _fused_rational_matrix(plan)
        wx = R.shape[1]
        nf = 48
        n = nf * Ipx + (wx - Ipx)
        x = np.random.default_rng(0).normal(size=(64, n)).astype(np.float32)
        y = frames_apply(x, R, Ipx, nf)
        y_ref = reference(x, R, Ipx, nf)
        assert y.shape == y_ref.shape
        # float32 accumulation over 343 taps of unit-variance input.
        np.testing.assert_allclose(y, y_ref, atol=5e-6)

    def test_small_stream_tile_odd_period(self):
        # Odd period (p2=3, ipx=2) on 8 streams: no alignment rule applies
        # to the plain lowering, every frame count is legal.
        rng = np.random.default_rng(1)
        p2, ipx, wx = 3, 2, 7
        R = rng.normal(size=(p2, wx))
        nf = 256
        n = nf * ipx + (wx - ipx)
        x = rng.normal(size=(8, n)).astype(np.float32)
        y = frames_apply(x, R, ipx, nf)
        y_ref = reference(x, R, ipx, nf)
        assert y.shape == y_ref.shape
        np.testing.assert_allclose(y, y_ref, atol=5e-6)

    def test_stream_count_not_a_tile_multiple(self):
        # Any stream count is served: 5 streams, CD->DAT geometry.
        plan = plan_engine(44100, 48000, Quality.HIGH)
        R, P2, Ipx, _lam = _fused_rational_matrix(plan)
        nf = 20
        n = nf * Ipx + (R.shape[1] - Ipx)
        x = np.random.default_rng(6).normal(size=(5, n)).astype(np.float32)
        y = frames_apply(x, R, Ipx, nf)
        assert y.shape == (5, nf * P2)
        np.testing.assert_allclose(y, reference(x, R, Ipx, nf), atol=5e-6)

    @pytest.mark.parametrize("ipx,wx,p2", [
        (294, 1100, 320),    # CD->DAT superframed
        (256, 1155, 128),    # decimation x2
        (160, 351, 147),     # 48k->44.1k (odd period)
        (160, 1100, 147),    # wide window, odd period
    ])
    def test_serving_geometries(self, ipx, wx, p2):
        rng = np.random.default_rng(ipx + wx)
        R = rng.normal(size=(p2, wx)) / np.sqrt(wx)
        nf = 9
        x = rng.normal(size=(4, nf * ipx + (wx - ipx))).astype(np.float32)
        np.testing.assert_allclose(frames_apply(x, R, ipx, nf),
                                   reference(x, R, ipx, nf), atol=5e-6)


class TestStreamingBandedCoverage:
    """Streaming blocks shorter than a whole number of frame tiles.

    [carry ++ block] covers exactly n_frames windows; the step must emit
    all of them (no tile flooring truncates the stream).
    """

    @pytest.mark.parametrize("rates,n_frames", [
        ((44100, 48000), 28),
        ((48000, 44100), 15),
    ])
    def test_short_block_padded_to_tile_span(self, rates, n_frames):
        plan = plan_engine(*rates, Quality.HIGH)
        R, P2, Ipx, _lam = _fused_rational_matrix(plan)
        wx = R.shape[1]
        carry = -(-(wx - Ipx) // Ipx) * Ipx
        data_len = carry + n_frames * Ipx
        rng = np.random.default_rng(5)
        data = rng.normal(size=(8, data_len)).astype(np.float32)
        y = frames_apply(data, R, Ipx, n_frames)
        assert y.shape == (8, n_frames * P2)
        np.testing.assert_allclose(y, reference(data, R, Ipx, n_frames),
                                   atol=1e-4)

    def test_step_emits_every_frame_and_keeps_carry(self):
        plan = plan_engine(44100, 48000, Quality.HIGH)
        R, P2, Ipx, _lam = _fused_rational_matrix(plan)
        wx = R.shape[1]
        carry_len = -(-(wx - Ipx) // Ipx) * Ipx
        rng = np.random.default_rng(8)
        carry = rng.normal(size=(3, carry_len)).astype(np.float32)
        x = rng.normal(size=(3, 7 * Ipx)).astype(np.float32)
        c2, y, n = strm._fused_banded_step(
            jnp.asarray(R.T, jnp.float32), jnp.asarray(carry),
            jnp.asarray(x), Ipx, wx, P2)
        assert int(n) == 7 * P2 and y.shape == (3, 7 * P2)
        data = np.concatenate([carry, x], axis=1)
        np.testing.assert_array_equal(np.asarray(c2), data[:, 7 * Ipx:])
        np.testing.assert_allclose(np.asarray(y),
                                   reference(data, R, Ipx, 7), atol=5e-6)


def tiles_reference(u, starts, M, count):
    w_band = M.shape[2]
    up = np.pad(u, ((0, 0), (0, w_band)))
    frames = np.stack([up[:, s:s + w_band] for s in starts], axis=1)
    y = np.einsum('stw,tpw->stp', frames.astype(np.float64), M)
    return y.reshape(u.shape[0], -1)[:, :count]


class TestBandedTiles:
    """Per-tile banded matrices at irregular starts (general/cubic core)."""

    def test_matches_gather_einsum(self):
        rng = np.random.default_rng(2)
        n_tiles, tile, w_band = 5, 256, 300
        starts = np.sort(rng.integers(0, 500, size=n_tiles)).astype(np.int32)
        M = rng.normal(size=(n_tiles, tile, w_band))
        x = rng.normal(size=(64, int(starts[-1]) + w_band)).astype(
            np.float32)
        count = n_tiles * tile
        y = np.asarray(_banded_tiles_apply(
            jnp.asarray(x), jnp.asarray(starts), jnp.asarray(M, jnp.float32),
            int(starts[-1]), count, jnp.float32))
        assert y.shape == (64, count)
        # float32 accumulation over w_band=300 taps vs the f64 reference
        np.testing.assert_allclose(y, tiles_reference(x, starts, M, count),
                                   atol=2e-4)

    def test_oneshot_general_path_tiles(self):
        import importlib
        osm = importlib.import_module('go_audio_resampler_tpu.engine.oneshot')
        plan = plan_engine(44100, 48001, Quality.HIGH)
        n = 4096
        count = plan.lengths.canonical(n)
        starts_np, M_np = osm._general_matrices(plan, count)
        rng = np.random.default_rng(3)
        u_len = int(np.max(starts_np)) + M_np.shape[2] + 8
        u = rng.normal(size=(8, u_len)).astype(np.float32)
        y = np.asarray(_banded_tiles_apply(
            jnp.asarray(u), jnp.asarray(starts_np, jnp.int32),
            jnp.asarray(M_np, jnp.float32), int(starts_np[-1]), count,
            jnp.float32))
        np.testing.assert_allclose(
            y, tiles_reference(u, starts_np, M_np, count),
            atol=2e-4, rtol=1e-4)

    def test_short_input_zero_padded(self):
        # Input ending inside the last tile's window reads zeros past its
        # end, not clipped repeats of the last sample.
        rng = np.random.default_rng(4)
        n_tiles, tile, w_band = 3, 16, 40
        starts = np.array([0, 10, 30], np.int32)
        M = rng.normal(size=(n_tiles, tile, w_band))
        x = rng.normal(size=(2, 45)).astype(np.float32)   # < 30 + 40
        count = n_tiles * tile
        y = np.asarray(_banded_tiles_apply(
            jnp.asarray(x), jnp.asarray(starts), jnp.asarray(M, jnp.float32),
            30, count, jnp.float32))
        np.testing.assert_allclose(y, tiles_reference(x, starts, M, count),
                                   atol=2e-5)
