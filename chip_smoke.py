"""Drive the resampler's serving path once on a GPU and check every result.

Usage:
    python chip_smoke.py             # one card: phases 1-6
    python chip_smoke.py --cards 4   # the 4-card sharded phase only

Phases (one JAX process for the whole run):

1. device: platform, kind, count, and the card's name and power limit
   from ``nvidia-smi``;
2. the device-resident serving step at deployment width:
   ``EngineCore(44.1k->48k HIGH, batch=1024, block=2352, float32)`` fed
   10 s of seeded audio per stream through ``process_device`` in 1 s
   chunks, then ``flush_device``;
3. other serving topologies: 256-stream 48k->16k decimation, the
   non-exact 44.1k->48,001 walk (256 streams), and ``TimeMajorEngine``
   against ``EngineCore``;
4. the public API: ``new_resampler`` stereo streaming, ``resample_mono``
   and the functional ``resample`` under ``jax.jit`` and ``jax.grad``;
5. the CLI, in this process, on a 10 s stereo WAV;
6. the quality floors of ``tools/quality_device.py`` on the card's
   float32 output, then the HIGH THD at each precision tier beside what
   the card runs each tier as.

Every phase compares its device output with a float64 numpy reference
of the same banded operator (``engine/oneshot.py`` host matrices), or
with the serial oracle in ``tests/oracle.py``, and raises on a miss.
The last line of standard output is one JSON object naming the device;
it is printed only when every phase passed.  Exits non-zero when JAX
finds no GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent

#: f32 device output against a float64 reference: float32 accumulation
#: over a few hundred taps of sigma = 0.5 input lands near 1e-6; 2e-5
#: leaves an order of magnitude for summation order, and a wrong tap,
#: phase or offset misses it by orders of magnitude.
TOL_F32 = 2e-5


@dataclasses.dataclass(frozen=True)
class Sizes:
    serving_streams: int = 1024
    serving_seconds: int = 10
    topo_streams: int = 256
    topo_seconds: int = 4
    general_seconds: int = 2
    api_seconds: int = 10
    functional_streams: int = 32
    cli_seconds: int = 10
    oracle_prefix: int = 2205
    ref_streams: int = 8


FULL = Sizes()
#: For rehearsing the phases on the CPU (never from the command line).
TINY = Sizes(serving_streams=8, serving_seconds=1, topo_streams=8,
             topo_seconds=1, general_seconds=1, api_seconds=1,
             functional_streams=4, cli_seconds=1, oracle_prefix=1000,
             ref_streams=2)


class PhaseFailed(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)


def require_gpu():
    """The default device, or exit non-zero when it is not a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX default device is "
              f"{devs[0].platform!r}); nothing was run", file=sys.stderr)
        raise SystemExit(2)
    return devs


def nvidia_smi() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def report(phase: str, seconds: float, err: float | None, tol: float | None,
           **extra) -> None:
    parts = [f"phase {phase}: ok", f"device_s={seconds:.6f}",
             f"peak_bytes_in_use={peak_bytes()}"]
    if err is not None:
        parts.append(f"max_abs_err={err:.3e} (tol {tol:g})")
    parts += [f"{k}={v}" for k, v in extra.items()]
    print("  ".join(parts), flush=True)


def rate(samples: int, secs: float) -> str:
    return f"{samples / secs / 1e6:.1f}" if secs > 0 else "n/a"


def timed(fn):
    """(result, seconds) of ``fn()``, waiting for every device result."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


# --- float64 references ----------------------------------------------------

def banded_reference(x, R, ipx: int, lam: int, count: int) -> np.ndarray:
    """Canonical output of a periodic banded operator, float64 on host.

    Period m reads (0^lam ++ x ++ 0...)[m*ipx : m*ipx + Wx] against
    R [P2, Wx] (engine/oneshot._poly_apply_rational_fused semantics).
    """
    x = np.asarray(x, np.float64)
    s, n = x.shape
    p2, wx = R.shape
    nf = -(-count // p2)
    xp = np.zeros((s, max((nf - 1) * ipx + wx, lam + n)))
    xp[:, lam:lam + n] = x
    win = np.lib.stride_tricks.sliding_window_view(xp, wx, axis=1)
    y = np.matmul(win[:, ::ipx][:, :nf], R.T)
    return y.reshape(s, nf * p2)[:, :count]


def rational_reference(plan, x) -> np.ndarray:
    from go_audio_resampler_tpu.engine.oneshot import _fused_rational_matrix

    R, _p2, ipx, lam = _fused_rational_matrix(plan)
    return banded_reference(x, R, ipx, lam,
                            plan.lengths.canonical(x.shape[1]))


def decim_reference(plan, x) -> np.ndarray:
    from go_audio_resampler_tpu.engine.oneshot import _decim_matrix

    R, _p, ipx = _decim_matrix(plan)
    return banded_reference(x, R, ipx, 0, plan.lengths.canonical(x.shape[1]))


def general_reference(plan, x) -> np.ndarray:
    """Non-exact walk: per-tile banded matrices over the prestage-padded
    input (engine/oneshot._poly_apply_general semantics)."""
    from go_audio_resampler_tpu.engine.oneshot import _general_matrices

    x = np.asarray(x, np.float64)
    n = x.shape[1]
    count = plan.lengths.canonical(n)
    starts, M = _general_matrices(plan, count)
    w = M.shape[2]
    xext = np.zeros((x.shape[0], max(int(starts[-1]) + w,
                                     plan.pre_taps - 1 + n)))
    xext[:, plan.pre_taps - 1:plan.pre_taps - 1 + n] = x
    win = np.stack([xext[:, s0:s0 + w] for s0 in starts], axis=1)
    y = np.einsum('stw,tpw->stp', win, M)
    return y.reshape(x.shape[0], -1)[:, :count]


def max_err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    check(got.shape == ref.shape, f"shape {got.shape} != reference "
                                  f"{ref.shape}")
    check(bool(np.isfinite(got).all()), "non-finite output")
    return float(np.abs(got - ref).max())


def seeded(seed: int, shape, device_side: bool = True):
    """sigma = 0.5 normal samples, float32, made on the device."""
    import jax
    import jax.numpy as jnp

    x = 0.5 * jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)
    return x if device_side else np.asarray(x)


# --- phases ------------------------------------------------------------------

def phase_device(devs) -> None:
    d = devs[0]
    print(f"device: platform={d.platform} kind={d.device_kind} "
          f"count={len(devs)}", flush=True)
    for line in nvidia_smi():
        print(f"nvidia-smi: {line}", flush=True)


def feed_device(eng, x, chunk: int, axis: int = 1):
    """process_device over ``chunk``-wide slices of ``axis``, then
    flush_device.

    Returns (outputs, steady seconds): the wall time of chunks 2..k,
    which reuse the program the first chunk compiled.  The flush, whose
    tail widths compile programs of their own, is not in it."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    n = x.shape[axis]
    check(n % chunk == 0, f"chunk {chunk} does not tile {n} samples")
    piece = jax.jit(lambda v, lo: lax.dynamic_slice_in_dim(v, lo, chunk,
                                                           axis=axis))
    outs = [jax.block_until_ready(eng.process_device(piece(x, jnp.int32(0))))]
    t0 = time.perf_counter()
    for lo in range(chunk, n, chunk):
        outs.append(eng.process_device(piece(x, jnp.int32(lo))))
    jax.block_until_ready(outs)
    secs = time.perf_counter() - t0
    outs.append(eng.flush_device())
    jax.block_until_ready(outs)
    return outs, secs


def phase_serving(sz: Sizes) -> None:
    import jax.numpy as jnp

    from go_audio_resampler_tpu.engine import EngineCore, plan_engine
    from go_audio_resampler_tpu.filterdesign import Quality

    sys.path.insert(0, str(ROOT / "tests"))
    from oracle import oracle_oneshot

    plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
    eng = EngineCore(plan, batch=sz.serving_streams, block=2352,
                     dtype=jnp.float32)
    n = sz.serving_seconds * 44100
    chunk = (44100 // eng.device_chunk_multiple) * eng.device_chunk_multiple
    x = seeded(1, (sz.serving_streams, n))
    outs, secs = feed_device(eng, x, chunk)
    total = sum(int(o.shape[1]) for o in outs)
    check(total == plan.lengths.canonical(n),
          f"output length {total} != canonical {plan.lengths.canonical(n)}")
    finite = all(bool(jnp.isfinite(o).all()) for o in outs)
    check(finite, "non-finite serving output")
    k = sz.ref_streams
    y = np.concatenate([np.asarray(o[:k]) for o in outs], axis=1)
    x_ref = np.asarray(x[:k], np.float64)
    err = max_err(y, rational_reference(plan, x_ref))
    check(err <= TOL_F32, f"serving step vs float64 banded: {err:.3e}")
    # Serial oracle (tests/oracle.py) over a prefix: outputs far from the
    # prefix end do not see the oracle's flush zeros.
    m = sz.oracle_prefix
    keep = plan.lengths.canonical(m) // 2
    err_o = 0.0
    for s in range(2):
        want = oracle_oneshot(plan, x_ref[s, :m])[:keep]
        err_o = max(err_o, float(np.abs(y[s, :keep] - want).max()))
    check(err_o <= TOL_F32, f"serving step vs serial oracle: {err_o:.3e}")
    report("2 serving 44.1k->48k", secs, err, TOL_F32,
           streams=sz.serving_streams, samples_per_stream=n,
           out_samples=total, oracle_err=f"{err_o:.3e}",
           steady_msamples_per_s=rate(sz.serving_streams * (n - chunk),
                                      secs))


def phase_topologies(sz: Sizes) -> None:
    import jax
    import jax.numpy as jnp

    from go_audio_resampler_tpu.engine import (EngineCore, TimeMajorEngine,
                                               plan_engine)
    from go_audio_resampler_tpu.filterdesign import Quality

    k = sz.ref_streams
    s = sz.topo_streams

    # 48k -> 16k integer decimation, device-resident.
    plan = plan_engine(48000.0, 16000.0, Quality.HIGH)
    eng = EngineCore(plan, batch=s, block=2048, dtype=jnp.float32)
    mult = eng.device_chunk_multiple
    chunk = (48000 // mult) * mult
    n = sz.topo_seconds * chunk
    x = seeded(2, (s, n))
    outs, secs = feed_device(eng, x, chunk)
    y = np.concatenate([np.asarray(o[:k]) for o in outs], axis=1)
    err = max_err(y, decim_reference(plan, np.asarray(x[:k], np.float64)))
    check(err <= TOL_F32, f"decimation vs float64 banded: {err:.3e}")
    report("3a decimation 48k->16k", secs, err, TOL_F32, streams=s,
           samples_per_stream=n,
           steady_msamples_per_s=rate(s * (n - chunk), secs))

    # Non-exact 44.1k -> 48,001: the polyphase walk (host-fed).
    plan = plan_engine(44100.0, 48001.0, Quality.HIGH)
    eng = EngineCore(plan, batch=s, block=2048, dtype=jnp.float32)
    n = sz.general_seconds * 44100
    x_np = seeded(3, (s, n), device_side=False)
    eng.process(x_np[:, :44100])                 # compile
    eng.reset()
    t0 = time.perf_counter()
    y = np.concatenate([eng.process(x_np[:, lo:lo + 44100])
                        for lo in range(0, n, 44100)] + [eng.flush()],
                       axis=1)
    secs = time.perf_counter() - t0
    err = max_err(y[:k], general_reference(plan, x_np[:k]))
    check(err <= TOL_F32, f"non-exact walk vs float64 tiles: {err:.3e}")
    report("3b non-exact 44.1k->48001 (host-fed)", secs, err, TOL_F32,
           streams=s, samples_per_stream=n, msamples_per_s=rate(s * n, secs))

    # Time-major engine against EngineCore, transposed.
    plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
    eng = EngineCore(plan, batch=s, block=2352, dtype=jnp.float32)
    tm = TimeMajorEngine(plan, batch=s, block=2352, dtype=jnp.float32)
    chunk = (44100 // tm.chunk_multiple) * tm.chunk_multiple
    n = sz.topo_seconds * chunk
    x = seeded(4, (s, n))
    xt = jax.block_until_ready(x.T)
    ref_outs, sm_secs = feed_device(eng, x, chunk)
    tm_outs, secs = feed_device(tm, xt, chunk, axis=0)
    y_sm = np.concatenate([np.asarray(o) for o in ref_outs], axis=1)
    y_tm = np.concatenate([np.asarray(o) for o in tm_outs], axis=0)
    err_core = max_err(y_tm, y_sm.T)
    check(err_core <= TOL_F32, f"time-major vs EngineCore: {err_core:.3e}")
    err = max_err(y_tm[:, :k].T,
                  rational_reference(plan, np.asarray(x[:k], np.float64)))
    check(err <= TOL_F32, f"time-major vs float64 banded: {err:.3e}")
    report("3c time-major 44.1k->48k", secs, err, TOL_F32, streams=s,
           vs_enginecore=f"{err_core:.3e}",
           steady_msamples_per_s=rate(s * (n - chunk), secs),
           enginecore_steady_msamples_per_s=rate(s * (n - chunk), sm_secs))


def phase_api(sz: Sizes) -> None:
    import jax
    import jax.numpy as jnp

    import go_audio_resampler_tpu as gar
    from go_audio_resampler_tpu import functional
    from go_audio_resampler_tpu.engine import plan_engine
    from go_audio_resampler_tpu.filterdesign import Quality

    high = gar.QualitySpec(preset=gar.QualityPreset.HIGH)
    # Stereo streaming through the public Resampler.
    n = sz.api_seconds * 44100
    x = seeded(5, (2, n), device_side=False)
    r = gar.new_resampler(gar.Config(44100, 48000, channels=2, quality=high,
                                     dtype=np.float32))
    t0 = time.perf_counter()
    parts = [r.process_multi([x[0, lo:lo + 8192], x[1, lo:lo + 8192]])
             for lo in range(0, n, 8192)]
    parts.append(r.flush_multi())
    secs = time.perf_counter() - t0
    y = np.stack([np.concatenate([p[c] for p in parts]) for c in range(2)])
    check(len(r._exec) == 1, "44.1k->48k HIGH should be one stage")
    err = max_err(y, rational_reference(r._exec[0].plan, x))
    check(err <= TOL_F32, f"Resampler stereo vs float64 banded: {err:.3e}")
    report("4a new_resampler stereo", secs, err, TOL_F32,
           samples_per_channel=n)

    # One-shot mono.
    plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
    gar.resample_mono(x[0], 44100, 48000, gar.QualityPreset.HIGH)
    (y1, secs) = timed(lambda: gar.resample_mono(x[0], 44100, 48000,
                                                 gar.QualityPreset.HIGH))
    err = max_err(y1[None], rational_reference(plan, x[:1]))
    check(err <= TOL_F32, f"resample_mono vs float64 banded: {err:.3e}")
    report("4b resample_mono", secs, err, TOL_F32)

    # Functional op under jit and grad, 32 streams x 1 s.
    fplan = functional._plan(44100.0, 48000.0, gar.QualityPreset.HIGH)
    xs = seeded(6, (sz.functional_streams, 44100))
    f = jax.jit(lambda v: gar.resample(v, 44100, 48000,
                                       quality=gar.QualityPreset.HIGH))
    y2 = jax.block_until_ready(f(xs))
    (y2, secs) = timed(lambda: f(xs))
    err = max_err(y2, rational_reference(fplan, np.asarray(xs, np.float64)))
    check(err <= TOL_F32, f"functional resample vs float64: {err:.3e}")
    w = seeded(7, y2.shape)
    g = jax.jit(jax.grad(lambda v: jnp.sum(f(v) * w)))
    (gx, gsecs) = timed(lambda: g(xs))
    check(gx.shape == xs.shape and bool(jnp.isfinite(gx).all()),
          "gradient shape or finiteness")
    # Adjoint identity <R x, w> == <x, R^T w>, both sides in float64.
    lhs = float(np.sum(np.asarray(y2, np.float64) * np.asarray(w)))
    rhs = float(np.sum(np.asarray(xs, np.float64) * np.asarray(gx)))
    rel = abs(lhs - rhs) / max(abs(lhs), 1e-30)
    check(rel <= 1e-4, f"adjoint identity off by {rel:.3e}")
    report("4c functional jit+grad", secs, err, TOL_F32,
           streams=sz.functional_streams, grad_s=f"{gsecs:.6f}",
           adjoint_rel=f"{rel:.3e}")


def phase_cli(sz: Sizes) -> None:
    import tempfile

    from go_audio_resampler_tpu.cli import resample_wav
    from go_audio_resampler_tpu.engine import plan_engine
    from go_audio_resampler_tpu.filterdesign import Quality
    from go_audio_resampler_tpu.utils.wav import WavReader, WavWriter

    n = sz.cli_seconds * 44100
    x = seeded(8, (2, n), device_side=False)
    plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = pathlib.Path(tmp) / "in.wav", pathlib.Path(tmp) / "out.wav"
        w = WavWriter(src, 44100, 2, "32f")
        w.write(x.T)
        w.close()
        t0 = time.perf_counter()
        rc = resample_wav.run([str(src), str(dst), "-rate", "48000",
                               "-quality", "high", "-bits", "32f"])
        secs = time.perf_counter() - t0
        check(rc == 0, f"CLI exit code {rc}")
        rd = WavReader(dst)
        rate, frames = rd.sample_rate, rd.num_frames
        y = rd.read(frames).T
        rd.close()
    check(rate == 48000, f"CLI wrote rate {rate}")
    check(frames == plan.lengths.canonical(n),
          f"CLI wrote {frames} frames, canonical {plan.lengths.canonical(n)}")
    # The CLI's default engine is float64 (x64 on the card); the file is
    # float32, so the reference holds to float32 rounding of |y| < ~2.
    err = max_err(y, rational_reference(plan, x))
    check(err <= 1e-6, f"CLI output vs float64 banded: {err:.3e}")
    report("5 CLI resample_wav", secs, err, 1e-6, rate=rate, frames=frames)


def tier_units(n: int = 4096) -> dict:
    """What the card runs each precision tier as.

    Each tier's float32 product is matched bit for bit against the
    explicit dot-algorithm presets; the relative error against float64
    is printed beside it (float32 ~1e-7, TF32 ~1e-4, bf16 ~1e-3).  A
    preset the backend refuses is reported as such: it is a probe, not
    a check."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from go_audio_resampler_tpu.ops.precision import dot_precision

    a = seeded(9, (n, 343))
    b = seeded(10, (343, 160))
    exact = np.asarray(a, np.float64) @ np.asarray(b, np.float64)
    presets = ["F32_F32_F32", "TF32_TF32_F32", "TF32_TF32_F32_X3",
               "BF16_BF16_F32", "BF16_BF16_F32_X3", "BF16_BF16_F32_X6"]
    preset_out = {}
    for name in presets:
        fn = jax.jit(lambda u, v, p=getattr(lax.DotAlgorithmPreset, name):
                     jnp.dot(u, v, precision=p,
                             preferred_element_type=jnp.float32))
        try:
            preset_out[name] = np.asarray(fn(a, b))
        except (ValueError, NotImplementedError,
                jax.errors.JaxRuntimeError) as e:
            print(f"  preset {name}: refused ({type(e).__name__})",
                  flush=True)
    out = {}
    for tier in ("highest", "high", "default"):
        y = np.asarray(jax.jit(lambda u, v, t=tier: jnp.dot(
            u, v, precision=dot_precision(t),
            preferred_element_type=jnp.float32))(a, b))
        same = [p for p, v in preset_out.items() if np.array_equal(v, y)]
        rel = float(np.abs(y - exact).max() / np.abs(exact).max())
        out[tier] = {"matches": same, "rel_err": rel}
    for p, v in preset_out.items():
        out[p] = {"rel_err": float(np.abs(v - exact).max()
                                   / np.abs(exact).max())}
    return out


def phase_quality() -> None:
    import jax.numpy as jnp

    sys.path.insert(0, str(ROOT / "tools"))
    import quality_device

    from go_audio_resampler_tpu.engine import EngineCore, plan_engine
    from go_audio_resampler_tpu.filterdesign import Quality
    from go_audio_resampler_tpu.utils import metrics, signals

    failures = []

    def record(name, value, ok, note=""):
        print(f"  quality [{'ok  ' if ok else 'FAIL'}] {name} = {value}"
              + (f"  ({note})" if note else ""), flush=True)
        if not ok:
            failures.append(name)

    t0 = time.perf_counter()
    quality_device.run_checks(record)
    check(not failures, f"quality floors failed: {failures}")
    report("6a quality floors", time.perf_counter() - t0, None, None)

    t0 = time.perf_counter()
    plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
    x = signals.sine(65536, 1000.0, 44100).astype(np.float32)[None]
    units = tier_units()
    for tier in ("highest", "high", "default"):
        eng = EngineCore(plan, batch=1, block=4096, dtype=jnp.float32,
                         precision=tier)
        y = np.concatenate([eng.process(x), eng.flush()], axis=1)[0]
        thd = metrics.thd(y.astype(np.float64), 48000, 1000.0, 16384)
        u = units[tier]
        print(f"  tier {tier}: thd_44k_48k_high_db={thd:.2f}  "
              f"runs_as={'+'.join(u['matches']) or 'no exact preset match'}"
              f"  matmul_rel_err={u['rel_err']:.3e}", flush=True)
        if tier == "highest":
            check(thd <= -140.0, f"highest-tier THD {thd:.2f} > -140")
    print("  presets: " + "  ".join(
        f"{p}={v['rel_err']:.3e}" for p, v in units.items()
        if p not in ("highest", "high", "default")), flush=True)
    report("6b precision tiers", time.perf_counter() - t0, None, None)


def phase_sharded(devs, n_cards: int, sz: Sizes) -> None:
    import jax
    import jax.numpy as jnp

    import go_audio_resampler_tpu as gar
    from go_audio_resampler_tpu import parallel
    from go_audio_resampler_tpu.engine import EngineCore, plan_engine, oneshot
    from go_audio_resampler_tpu.filterdesign import Quality
    from go_audio_resampler_tpu.parallel.mesh import STREAM_AXIS

    check(len(devs) >= n_cards, f"need {n_cards} devices, have {len(devs)}")
    mesh = parallel.make_mesh(n_cards)
    print(f"mesh: 1-D over {[d.id for d in mesh.devices.flat]}", flush=True)
    per = max(sz.topo_streams // n_cards, 1)
    s = per * n_cards
    fused = gar.new_resampler(gar.Config(
        48000, 8000, channels=1, quality=gar.QualitySpec(
            preset=gar.QualityPreset.HIGH), dtype=np.float32))._fused
    check(fused is not None, "48k->8k chain did not fuse")
    plans = [("44.1k->48k", plan_engine(44100.0, 48000.0, Quality.HIGH),
              44100),
             ("fused 48k->8k", fused.plan, 48000)]
    for name, plan, rate in plans:
        n = sz.topo_seconds * rate
        x = seeded(11, (s, n), device_side=False)
        twin = EngineCore(plan, batch=s, block=4096, dtype=jnp.float32)
        ref = np.concatenate([twin.process(x), twin.flush()], axis=1)
        sh = parallel.ShardedEngineCore(plan, mesh, batch_per_device=per,
                                        block=4096, dtype=jnp.float32)
        (got, secs) = timed(lambda: np.concatenate(
            [sh.process(x), sh.flush()], axis=1))
        err = max_err(got, ref)
        check(err <= TOL_F32, f"sharded process vs one card: {err:.3e}")
        report(f"7 sharded process {name}", secs, err, TOL_F32, streams=s)

        shd = parallel.ShardedEngineCore(plan, mesh, batch_per_device=per,
                                         block=4096, dtype=jnp.float32)
        mult = shd.device_chunk_multiple
        chunk = (rate // mult) * mult
        m = (n // chunk) * chunk
        x_d = jax.device_put(jnp.asarray(x[:, :m]),
                             jax.sharding.NamedSharding(
                                 mesh, jax.sharding.PartitionSpec(
                                     STREAM_AXIS, None)))
        outs, secs = feed_device(shd, x_d, chunk)
        placed = {d.id for o in outs if o.shape[1]
                  for d in o.sharding.device_set}
        check(len(placed) == n_cards,
              f"device-mode output on devices {sorted(placed)}")
        twin_d = EngineCore(plan, batch=s, block=4096, dtype=jnp.float32)
        ref_d = np.concatenate(
            [twin_d.process(x[:, :m]), twin_d.flush()], axis=1)
        got_d = np.concatenate([np.asarray(o) for o in outs], axis=1)
        err = max_err(got_d, ref_d)
        check(err <= TOL_F32, f"sharded device mode vs one card: {err:.3e}")
        report(f"7 sharded process_device {name}", secs, err, TOL_F32,
               output_devices=sorted(placed))

    plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
    x = seeded(12, (s, 44100), device_side=False)
    (y, secs) = timed(lambda: parallel.sharded_oneshot(plan, x, mesh))
    placed = sorted(d.id for d in y.sharding.device_set)
    check(len(placed) == n_cards, f"sharded_oneshot on devices {placed}")
    ref = np.asarray(oneshot(plan, x, dtype=np.float32))
    err = max_err(y, ref)
    check(err <= TOL_F32, f"sharded_oneshot vs one card: {err:.3e}")
    report("7 sharded_oneshot 44.1k->48k", secs, err, TOL_F32,
           output_devices=placed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="4: run only the sharded phase on a 4-card mesh")
    args = ap.parse_args(argv)
    devs = require_gpu()
    sys.path.insert(0, str(ROOT))
    from go_audio_resampler_tpu.utils import compile_cache
    compile_cache.enable()

    t0 = time.perf_counter()
    phase_device(devs)
    if args.cards > 1:
        phase_sharded(devs, args.cards, FULL)
    else:
        phase_serving(FULL)
        phase_topologies(FULL)
        phase_api(FULL)
        phase_quality()
        phase_cli(FULL)          # last: the float64 CLI engine turns x64 on
    print(f"total_s={time.perf_counter() - t0:.1f}", flush=True)
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
