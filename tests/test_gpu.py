"""Tests that need the card (marker ``gpu``; they skip on the CPU).

Run on a GPU machine with ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_serving_step_matches_float64(gpu):
    import jax.numpy as jnp

    from go_audio_resampler_tpu.engine import EngineCore, plan_engine
    from go_audio_resampler_tpu.engine.oneshot import _fused_rational_matrix
    from go_audio_resampler_tpu.filterdesign import Quality

    plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
    eng = EngineCore(plan, batch=64, block=2352, dtype=jnp.float32)
    n = 100 * eng.device_chunk_multiple
    x = (np.random.default_rng(0).normal(size=(64, n)) * 0.5).astype(
        np.float32)
    y = np.concatenate([np.asarray(eng.process_device(jnp.asarray(x))),
                        np.asarray(eng.flush_device())], axis=1)
    R, p2, ipx, lam = _fused_rational_matrix(plan)
    count = plan.lengths.canonical(n)
    nf = -(-count // p2)
    xp = np.zeros((64, (nf - 1) * ipx + R.shape[1] + lam + n))
    xp[:, lam:lam + n] = x
    frames = np.stack([xp[:, m * ipx:m * ipx + R.shape[1]]
                       for m in range(nf)], axis=1)
    ref = (frames @ R.T).reshape(64, -1)[:, :count]
    assert y.shape == ref.shape
    assert np.abs(y - ref).max() < 2e-5


def test_banded_emit_is_the_gpu_lowering(gpu):
    from go_audio_resampler_tpu.ops import lowering

    assert lowering.banded_poly_emit()
