"""Entry points that must refuse the CPU, and the compile-cache rule.

``chip_smoke.py``, ``bench.py`` and ``benchmarks/run_all.py`` measure or
check the card; on a CPU they must exit non-zero and print no result.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run_on_cpu(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py",
                                    "benchmarks/run_all.py"])
def test_script_refuses_cpu(script):
    proc = _run_on_cpu(script)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    for line in proc.stdout.splitlines():
        assert '"ok"' not in line and "Msamples" not in line


def test_chip_smoke_require_gpu_exits_in_process():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert exc.value.code != 0


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the checkout, the script cannot import the package."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert not any(_is_ok_line(ln) for ln in proc.stdout.splitlines())


def _is_ok_line(line):
    try:
        return json.loads(line).get("ok") is True
    except (ValueError, AttributeError):
        return False


def test_banded_reference_matches_engine_oneshot():
    """chip_smoke's float64 reference agrees with the f64 one-shot path."""
    import numpy as np

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from go_audio_resampler_tpu.engine import oneshot, plan_engine
    from go_audio_resampler_tpu.filterdesign import Quality

    rng = np.random.default_rng(0)
    for inr, outr, ref in [(44100, 48000, chip_smoke.rational_reference),
                           (48000, 16000, chip_smoke.decim_reference),
                           (44100, 48001, chip_smoke.general_reference)]:
        plan = plan_engine(float(inr), float(outr), Quality.HIGH)
        x = rng.normal(size=(2, 3000)) * 0.5
        want = np.asarray(oneshot(plan, x, dtype=np.float64))
        np.testing.assert_allclose(ref(plan, x), want, atol=1e-12)


class TestCompileCache:
    def test_env_var_left_in_charge(self, monkeypatch, tmp_path):
        import jax
        from go_audio_resampler_tpu.utils import compile_cache

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        before = jax.config.jax_compilation_cache_dir
        assert compile_cache.cache_dir() == str(tmp_path)
        assert compile_cache.enable(0.3) == str(tmp_path)
        # The program sets no directory of its own.
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_fixed_checkout_path(self, monkeypatch):
        from go_audio_resampler_tpu.utils import compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert compile_cache.cache_dir() == str(ROOT / ".jax_cache")
        # Same answer every call: no pid, time or temp name in it.
        assert compile_cache.cache_dir() == compile_cache.cache_dir()

    def test_enable_sets_default_dir(self, monkeypatch):
        import jax
        from go_audio_resampler_tpu.utils import compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = compile_cache.enable(0.3)
        assert jax.config.jax_compilation_cache_dir == path
        assert path == str(ROOT / ".jax_cache")
