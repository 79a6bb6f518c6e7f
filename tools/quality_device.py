"""Quality floors measured on the default device's float32 output.

The CPU x64 suite (tests/) proves the math; this tool checks the
*shipped* compute path: float32 through the default lowerings on
whatever backend JAX picks (the GPU on a card's machine).  It runs the
THD / DC-gain / anti-alias / ripple metrics on device output, asserts the
float32 floors the suite pins (tests/test_quality_f32.py), runs the
streaming engine on a non-exact ratio, and soaks a randomized-chunk
stream with a checkpoint under load.  It writes no record; ``chip_smoke.py``
phase 6 runs the same checks and prints them.

Reference anchor: the Go suite measures its quality thresholds against
the same engine it ships (quality_regression_test.go:26-58).

Usage:  python tools/quality_device.py
Exit code 1 if any floor fails.
"""

from __future__ import annotations

import importlib
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

N = 65536
FFT = 16384


def run_checks(record) -> None:
    """Run every floor; ``record(name, value, ok, note)`` collects each."""
    from go_audio_resampler_tpu.engine import EngineCore, plan_engine
    from go_audio_resampler_tpu.filterdesign import Quality
    from go_audio_resampler_tpu.utils import metrics, signals
    osm = importlib.import_module('go_audio_resampler_tpu.engine.oneshot')

    def run(plan, x):
        return np.asarray(osm.oneshot(plan, np.asarray(x, np.float32)[None],
                                      dtype=np.float32))[0].astype(np.float64)

    # --- THD floors (f32, default lowering) ------------------------------
    for q, floor in [(Quality.LOW, -130.0), (Quality.HIGH, -140.0),
                     (Quality.VERY_HIGH, -140.0)]:
        plan = plan_engine(44100.0, 48000.0, q)
        y = run(plan, signals.sine(N, 1000.0, 44100))
        val = metrics.thd(y, 48000, 1000.0, FFT)
        record(f"thd_44k_48k_{q.name.lower()}_db", round(val, 2),
               val <= floor, f"floor {floor}")

    # --- decimation THD + steady-state anti-alias ------------------------
    plan = plan_engine(96000.0, 48000.0, Quality.HIGH)
    y = run(plan, signals.sine(N, 1000.0, 96000))
    val = metrics.thd(y, 48000, 1000.0, FFT)
    record("thd_96k_48k_high_db", round(val, 2), val <= -130.0,
           "floor -130")

    # alias rejection: tone above the output Nyquist must vanish
    f_alias = 30000.0   # 96k tone at 30 kHz -> aliases to 18 kHz at 48k out
    y = run(plan, signals.sine(N, f_alias, 96000))
    mid = y[len(y) // 4: -len(y) // 4]
    att = -20.0 * np.log10(max(np.sqrt(np.mean(mid ** 2)) * np.sqrt(2.0),
                               1e-12))
    record("alias_rejection_96k_48k_db", round(att, 1), att >= 100.0,
           "floor 100 (f32 noise floor bounds this, not the filter)")

    # --- DC gain ----------------------------------------------------------
    plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
    dc = metrics.dc_gain(run(plan, signals.dc(16384)))
    record("dc_gain_44k_48k_high", round(float(dc), 6),
           abs(dc - 1.0) <= 1e-3, "|dc-1| <= 1e-3")

    # --- passband ripple --------------------------------------------------
    amps = []
    for f in [1000.0, 5000.0, 10000.0, 15000.0]:
        y = run(plan, signals.sine(N, f, 44100))
        mid = y[len(y) // 4: -len(y) // 4]
        amps.append(np.sqrt(np.mean(mid ** 2)) * np.sqrt(2.0))
    ripple = 20.0 * np.log10(max(amps) / min(amps))
    record("passband_ripple_44k_48k_db", round(float(ripple), 4),
           ripple <= 2.0, "floor 2.0 dB p-p")

    # --- streaming engine, non-exact ratio (the polyphase walk) ----------
    plan = plan_engine(44100.0, 48001.0, Quality.HIGH)
    xs = signals.sine(N, 1000.0, 44100).astype(np.float32)
    eng = EngineCore(plan, batch=1, block=4096, dtype=np.float32)
    chunks = [eng.process(xs[None, i:i + 4096])
              for i in range(0, len(xs), 4096)]
    chunks.append(eng.flush())
    y_s = np.concatenate([c[0] for c in chunks]).astype(np.float64)
    val = metrics.thd(y_s, 48001, 1000.0, FFT)
    record("thd_stream_44k_48k001_high_db", round(val, 2), val <= -85.0,
           "floor -85: the cubic inter-phase coefficient interpolation "
           "bounds non-exact ratios (~-88.7 in float64 too, same walk "
           "semantics as the reference)")
    y_o = run(plan, xs)
    m = min(len(y_s), len(y_o))
    d = float(np.abs(y_s[:m] - y_o[:m]).max())
    record("stream_vs_oneshot_general_maxdiff", d,
           len(y_s) == len(y_o) and d <= 2e-5, "tol 2e-5, equal lengths")

    # --- HQ inter-phase mode (beyond reference, opt-in) ------------------
    plan_hq = plan_engine(44100.0, 48001.0, Quality.HIGH, False, True)
    eng_hq = EngineCore(plan_hq, batch=1, block=4096, dtype=np.float32)
    chunks = [eng_hq.process(xs[None, i:i + 4096])
              for i in range(0, len(xs), 4096)]
    chunks.append(eng_hq.flush())
    y_hq = np.concatenate([c[0] for c in chunks]).astype(np.float64)
    val = metrics.thd(y_hq, 48001, 1000.0, FFT)
    record("thd_stream_44k_48k001_hq_interp_db", round(val, 2),
           val <= -120.0, "floor -120 (f64 measures -162.1)")

    # --- soak: randomized chunks, checkpoint under load ------------------
    # ~15 s of 8-lane audio in randomized host chunks must equal one bulk
    # call bit for bit (identical compiled per-block launches); one
    # checkpoint at a random seam resumes bit-identically; the input FIFO
    # stays bounded while it is being fed.
    import tempfile
    from go_audio_resampler_tpu.engine import (load_stream_state,
                                               save_stream_state)
    n_soak = 15 * 44100
    rng_s = np.random.default_rng(7)
    plan_s = plan_engine(44100.0, 48000.0, Quality.HIGH)
    x_soak = (rng_s.standard_normal((8, n_soak)) * 0.5).astype(np.float32)

    bulk = EngineCore(plan_s, batch=8, block=8192, dtype=np.float32)
    y_bulk = np.concatenate([bulk.process(x_soak), bulk.flush()], axis=1)

    cut = int(rng_s.integers(n_soak // 4, 3 * n_soak // 4))
    cuts = [0]
    while cuts[-1] < n_soak:
        cuts.append(min(n_soak, cuts[-1] + int(rng_s.integers(1, 70000))))
    cuts = sorted(set(cuts + [cut]))

    a = EngineCore(plan_s, batch=8, block=8192, dtype=np.float32)
    parts = []
    peak_pending, peak_cap = 0, 0
    with tempfile.TemporaryDirectory() as tmp:
        ck = pathlib.Path(tmp) / "soak.npz"
        for lo, hi in zip(cuts, cuts[1:]):
            parts.append(a.process(x_soak[:, lo:hi]))
            peak_pending = max(peak_pending, a._pending.available())
            peak_cap = max(peak_cap, a._pending._buf.shape[-1])
            if hi == cut:
                save_stream_state(a, ck)
        y_a = np.concatenate(parts + [a.flush()], axis=1)
        b = EngineCore(plan_s, batch=8, block=8192, dtype=np.float32)
        load_stream_state(b, ck)
    n_pre = cuts.index(cut)                  # chunks fully fed before ck
    pre = np.concatenate(parts[:n_pre], axis=1)
    tail_cuts = [c for c in cuts if c >= cut]
    tail = [b.process(x_soak[:, lo:hi])
            for lo, hi in zip(tail_cuts, tail_cuts[1:])]
    y_resumed = np.concatenate([pre] + tail + [b.flush()], axis=1)

    d_bulk = (float(np.abs(y_a - y_bulk).max())
              if y_a.shape == y_bulk.shape else float("inf"))
    record("soak_random_chunks_equal_bulk_maxdiff", d_bulk, d_bulk == 0.0,
           f"{len(cuts) - 1} randomized chunks vs one bulk call, bit-equal")
    d_ck = (float(np.abs(y_resumed - y_bulk).max())
            if y_resumed.shape == y_bulk.shape else float("inf"))
    record("soak_checkpoint_resume_maxdiff", d_ck, d_ck == 0.0,
           f"checkpoint at sample {cut}, resumed bit-identically")
    record("soak_host_state_bounded", int(peak_cap),
           peak_pending < 2 * a.block and peak_cap <= 8 * max(a.block, 70000),
           f"peak FIFO backlog {peak_pending} < 2 blocks while feeding")


def main() -> int:
    import jax

    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    failures = []

    def record(name, value, ok, note=""):
        print(f"  [{'ok  ' if ok else 'FAIL'}] {name} = {value}"
              + (f"  ({note})" if note else ""))
        if not ok:
            failures.append(name)

    run_checks(record)
    print(f"{len(failures)} failure(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
