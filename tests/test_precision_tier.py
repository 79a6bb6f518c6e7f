"""Matmul precision tier (GAR_TPU_MATMUL_PRECISION) plumbing tests.

``ops.precision.dot_precision`` routes every banded/framing hot-path dot
through one tier (default ``highest`` = full float32 numerics).  These
tests pin the tier map, verify the requested tier reaches the traced
dot_general, and that the tiers' numerics are byte-stable on the CPU
suite (where precision is a no-op).  What each tier runs as on the GPU
is established on the card by ``chip_smoke.py``.

The env var is read at TRACE time: toggling it in a live process requires
clearing jit caches.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import lax

from go_audio_resampler_tpu.ops import precision as tiers


class TestTierMap:
    def test_default_is_highest(self, monkeypatch):
        monkeypatch.delenv("GAR_TPU_MATMUL_PRECISION", raising=False)
        assert tiers.dot_precision() == lax.Precision.HIGHEST

    @pytest.mark.parametrize("name,want", [
        ("default", lax.Precision.DEFAULT),
        ("high", lax.Precision.HIGH),
        ("highest", lax.Precision.HIGHEST),
        ("HIGH", lax.Precision.HIGH),       # case-insensitive
    ])
    def test_env_selects_tier(self, monkeypatch, name, want):
        monkeypatch.setenv("GAR_TPU_MATMUL_PRECISION", name)
        assert tiers.dot_precision() == want

    def test_unknown_tier_raises(self, monkeypatch):
        monkeypatch.setenv("GAR_TPU_MATMUL_PRECISION", "bf16")
        with pytest.raises(KeyError):
            tiers.dot_precision()

    @pytest.mark.parametrize("pin,want", [
        ("highest", lax.Precision.HIGHEST),
        ("HIGH", lax.Precision.HIGH),
        ("default", lax.Precision.DEFAULT),
    ])
    def test_pin_ignores_env(self, monkeypatch, pin, want):
        monkeypatch.setenv("GAR_TPU_MATMUL_PRECISION", "high")
        assert tiers.dot_precision(pin) == want

    def test_auto_pin_reads_env(self, monkeypatch):
        monkeypatch.setenv("GAR_TPU_MATMUL_PRECISION", "default")
        assert tiers.dot_precision("auto") == lax.Precision.DEFAULT

    def test_modes_cover_every_tier(self):
        assert set(tiers.PRECISION_MODES) == (
            {"auto"} | set(tiers._PRECISION_TIERS))


class TestTierReachesTrace:
    """The env tier must appear in the traced dot_general of the hot paths."""

    def _trace_streaming_step(self):
        from go_audio_resampler_tpu.engine.streaming import \
            _banded_frames_apply

        x = jnp.zeros((2, 40), jnp.float32)
        r_t = jnp.zeros((24, 8), jnp.float32)
        return str(jax.make_jaxpr(
            lambda d: _banded_frames_apply(d, r_t, 8, 24, 8, 3))(x))

    def test_high_vs_highest_differ_in_trace(self, monkeypatch):
        monkeypatch.setenv("GAR_TPU_MATMUL_PRECISION", "highest")
        j_highest = self._trace_streaming_step()
        monkeypatch.setenv("GAR_TPU_MATMUL_PRECISION", "high")
        j_high = self._trace_streaming_step()
        assert "HIGHEST" in j_highest
        assert "HIGHEST" not in j_high and "HIGH" in j_high


class TestCpuNumericsUnchanged:
    """On CPU the precision attr is advisory: tiers must not change output
    (guards against the knob accidentally altering shapes/semantics)."""

    @pytest.mark.parametrize("tier", ["auto", "highest", "high", "default"])
    def test_engine_tiers_equal_output(self, tier):
        from go_audio_resampler_tpu.engine import EngineCore, plan_engine
        from go_audio_resampler_tpu.filterdesign import Quality

        plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
        x = np.random.default_rng(9).normal(
            size=(2, 4096)).astype(np.float32)
        eng = EngineCore(plan, batch=2, block=2048, dtype=np.float32,
                         precision=tier)
        ref = EngineCore(plan, batch=2, block=2048, dtype=np.float32)
        got = np.concatenate([eng.process(x), eng.flush()], axis=1)
        want = np.concatenate([ref.process(x), ref.flush()], axis=1)
        np.testing.assert_array_equal(got, want)

    def test_oneshot_tier_invariant_cpu(self, monkeypatch):
        import importlib

        from go_audio_resampler_tpu.engine import plan_engine
        from go_audio_resampler_tpu.filterdesign import Quality
        osm = importlib.import_module('go_audio_resampler_tpu.engine.oneshot')

        plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
        x = jnp.asarray(np.random.default_rng(3).normal(
            size=(2, 4000)).astype(np.float32))
        monkeypatch.setenv("GAR_TPU_MATMUL_PRECISION", "highest")
        osm._oneshot_jit.clear_cache()
        y_hi = np.asarray(osm.oneshot(plan, x, dtype=np.float32))
        monkeypatch.setenv("GAR_TPU_MATMUL_PRECISION", "high")
        osm._oneshot_jit.clear_cache()
        try:
            y_3p = np.asarray(osm.oneshot(plan, x, dtype=np.float32))
        finally:
            osm._oneshot_jit.clear_cache()
        assert y_hi.shape == y_3p.shape
        np.testing.assert_array_equal(y_hi, y_3p)


class TestPerEnginePrecisionPin:
    """Round-4: per-engine `precision=` pins the tier of the fused banded
    steps independently of the process-global env (and is part of the
    static jit key, so engines on different tiers coexist)."""

    def _trace(self, precision):
        from go_audio_resampler_tpu.engine.streaming import \
            _banded_frames_apply

        x = jnp.zeros((2, 40), jnp.float32)
        r_t = jnp.zeros((24, 8), jnp.float32)
        return str(jax.make_jaxpr(
            lambda d: _banded_frames_apply(d, r_t, 8, 24, 8, 3,
                                           precision))(x))

    def test_pin_overrides_env(self, monkeypatch):
        monkeypatch.setenv("GAR_TPU_MATMUL_PRECISION", "default")
        j = self._trace("highest")
        assert "HIGHEST" in j
        monkeypatch.setenv("GAR_TPU_MATMUL_PRECISION", "highest")
        j2 = self._trace("high")
        assert "HIGHEST" not in j2 and "HIGH" in j2

    def test_auto_follows_env(self, monkeypatch):
        monkeypatch.setenv("GAR_TPU_MATMUL_PRECISION", "high")
        j = self._trace("auto")
        assert "HIGHEST" not in j and "HIGH" in j

    def test_engine_ctor_validates_and_stores(self):
        from go_audio_resampler_tpu.engine import EngineCore, plan_engine
        from go_audio_resampler_tpu.filterdesign import Quality

        plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
        eng = EngineCore(plan, batch=1, precision="highest")
        assert eng.precision == "highest"
        with pytest.raises(ValueError, match="precision"):
            EngineCore(plan, batch=1, precision="bf16")

    def test_engines_with_different_pins_match_on_cpu(self):
        # Tier is numerically a no-op on CPU f64: two engines with
        # different pins must emit identical streams (plumbing check —
        # the pin changes only the matmul unit on the GPU).
        from go_audio_resampler_tpu.engine import EngineCore, plan_engine
        from go_audio_resampler_tpu.filterdesign import Quality

        plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
        x = np.random.default_rng(73).standard_normal((1, 5000)) * 0.5
        outs = {}
        for pin in ("highest", "default"):
            eng = EngineCore(plan, batch=1, block=512, dtype=np.float64,
                             precision=pin)
            outs[pin] = np.concatenate([eng.process(x), eng.flush()],
                                       axis=1)
        np.testing.assert_array_equal(outs["highest"], outs["default"])

    def _general_engine_jaxpr(self, precision):
        """Jaxpr of the general (non-exact) two-stage walk's step with a
        per-engine pin — round-5: the pin now covers the non-banded
        topologies (prestage conv + poly emit), not just the fused
        banded steps."""
        from go_audio_resampler_tpu.engine import EngineCore, plan_engine
        from go_audio_resampler_tpu.filterdesign import Quality

        plan = plan_engine(44100.0, 48001.0, Quality.HIGH)
        assert plan.kind == 'two_stage' and not plan.is_rational_exact
        eng = EngineCore(plan, batch=2, block=256, dtype=np.float32,
                         precision=precision)
        core = eng.core_fn()
        st0 = eng._init_state()
        x = jnp.zeros((2, eng.block), jnp.float32)
        return str(jax.make_jaxpr(core)(st0, x))

    def test_general_walk_pin_overrides_env(self, monkeypatch):
        monkeypatch.setenv("GAR_TPU_MATMUL_PRECISION", "default")
        j = self._general_engine_jaxpr("highest")
        assert "HIGHEST" in j
        monkeypatch.setenv("GAR_TPU_MATMUL_PRECISION", "highest")
        j2 = self._general_engine_jaxpr("default")
        assert "HIGHEST" not in j2

    def test_dft_up_pin_overrides_env(self, monkeypatch):
        from go_audio_resampler_tpu.engine import EngineCore, plan_engine
        from go_audio_resampler_tpu.filterdesign import Quality

        monkeypatch.setenv("GAR_TPU_MATMUL_PRECISION", "default")
        plan = plan_engine(24000.0, 48000.0, Quality.HIGH)
        assert plan.kind == 'dft_up'
        eng = EngineCore(plan, batch=2, block=256, dtype=np.float32,
                         precision="highest")
        core = eng.core_fn()
        j = str(jax.make_jaxpr(core)(eng._init_state(),
                                     jnp.zeros((2, eng.block), jnp.float32)))
        assert "HIGHEST" in j

    def test_general_engines_with_different_pins_match_on_cpu(self):
        # Plumbing check on the general topology: the pin must not alter
        # values on the CPU (f64 path ignores the tier numerically).
        from go_audio_resampler_tpu.engine import EngineCore, plan_engine
        from go_audio_resampler_tpu.filterdesign import Quality

        plan = plan_engine(44100.0, 48001.0, Quality.HIGH)
        x = np.random.default_rng(74).standard_normal((1, 4000)) * 0.5
        outs = {}
        for pin in ("highest", "default"):
            eng = EngineCore(plan, batch=1, block=512, dtype=np.float64,
                             precision=pin)
            outs[pin] = np.concatenate([eng.process(x), eng.flush()],
                                       axis=1)
        np.testing.assert_array_equal(outs["highest"], outs["default"])

    def test_config_plumbs_precision(self):
        import go_audio_resampler_tpu as gar

        r = gar.new_resampler(gar.Config(
            44100, 48000,
            quality=gar.QualitySpec(preset=gar.QualityPreset.HIGH),
            dtype=np.float64, precision="highest"))
        assert all(getattr(e, "precision", "highest") == "highest"
                   for e in r._exec)
        with pytest.raises(gar.InvalidConfigError, match="precision"):
            gar.Config(44100, 48000, precision="fast").validate()
