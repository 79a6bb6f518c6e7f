"""The one module that picks a lowering per platform (ops/lowering.py)."""

import jax
import pytest

from go_audio_resampler_tpu.ops import convolve, lowering


@pytest.mark.parametrize("backend,conv,emit", [
    ("cpu", "frames", False),
    ("gpu", "banded", True),
])
def test_choices_per_backend(monkeypatch, backend, conv, emit):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert lowering.conv_impl() == conv
    assert lowering.banded_poly_emit() is emit


def test_conv_override_wins(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    convolve.set_conv_impl("xla")
    try:
        assert convolve._impl() == "xla"
    finally:
        convolve.set_conv_impl(None)
    assert convolve._impl() == "banded"


def test_emit_choice_reaches_the_trace(monkeypatch):
    """On the GPU path the emit traces the banded tile matmul, whose
    span-wide slab gather is absent from the per-output gather path."""
    import jax.numpy as jnp
    import numpy as np

    from go_audio_resampler_tpu.engine import plan_engine, stages
    from go_audio_resampler_tpu.filterdesign import Quality

    plan = plan_engine(44100.0, 48001.0, Quality.HIGH)
    banks = tuple(jnp.asarray(b, jnp.float32) for b in
                  (plan.bank_a, plan.bank_b, plan.bank_c, plan.bank_d))
    hist = jnp.zeros((2, 4096), jnp.float32)

    def trace():
        return str(jax.make_jaxpr(lambda h: stages.poly_emit(
            banks, h, jnp.int32(4000), jnp.int32(0), jnp.int32(0),
            plan.num_phases, plan.poly_taps, plan.step_hi, plan.step_lo,
            512)[0])(hist))

    gather_path = trace()
    monkeypatch.setattr(lowering, "banded_poly_emit", lambda: True)
    banded_path = trace()
    assert banded_path != gather_path
    assert np.sum([ln.count("select_n") for ln in banded_path.splitlines()]) \
        > np.sum([ln.count("select_n") for ln in gather_path.splitlines()])
