"""HQ non-exact ratios and time-major serving.

Two things the reference library cannot do:

1. ``hq_interp=True`` — the upstream's general (non-exact-ratio) walk
   interpolates its phase banks with a boundary-wrap defect that floors
   THD at ~-88 dB (polyphase_stage.go:105-117; reproduced bit-for-bit
   by default, for parity).  The opt-in mode corrects the wrap and
   designs 8x denser banks at the SAME per-output cost: measured
   -162 dB THD in float64, -155 dB in float32 on an H200 (700 W).

2. ``engine.TimeMajorEngine`` — device-resident serving for data stored
   time-major ([samples, streams]), which interleaved multi-channel
   audio already is.  The step gathers row windows and multiplies them
   in one einsum with no transpose (see DESIGN.md section 6).

Run:  python examples/hq_and_time_major.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import go_audio_resampler_tpu as gar
from go_audio_resampler_tpu.utils.metrics import thd


def hq_interp_demo():
    """44.1k -> 48,001 Hz (no small rational form): default vs HQ."""
    rate_in, rate_out = 44100, 48001
    t = np.arange(rate_in) / rate_in
    x = 0.9 * np.sin(2 * np.pi * 997.0 * t)

    for hq in (False, True):
        # float32 engine: runs on GPU and CPU alike (the f64 twin,
        # gar.new_engine, needs jax_enable_x64).
        eng = gar.new_engine_float32(rate_in, rate_out,
                                     gar.QualityPreset.HIGH, hq_interp=hq)
        y = np.concatenate([eng.process(x), eng.flush()])
        val = thd(y, rate_out, 997.0)
        mode = "hq_interp" if hq else "default (reference parity)"
        print(f"  {mode:28s} THD = {val:8.2f} dB   ({len(y)} samples)")


def time_major_demo():
    """CD->DAT serving on interleaved ([samples, channels]) data."""
    import jax.numpy as jnp

    from go_audio_resampler_tpu.engine import (TimeMajorEngine, plan_engine)
    from go_audio_resampler_tpu.filterdesign import Quality

    channels = 8
    plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
    eng = TimeMajorEngine(plan, batch=channels, block=2048)

    # Interleaved audio is already [samples, channels]: no transpose.
    n = 4 * eng.chunk_multiple * (2048 // eng.chunk_multiple)
    rng = np.random.default_rng(7)
    xt = jnp.asarray(rng.standard_normal((n, channels)).astype(np.float32))

    chunks = [eng.process_device(c)
              for c in jnp.split(xt, 4, axis=0)]     # stays on device
    chunks.append(eng.flush_device())
    yt = jnp.concatenate([c for c in chunks if c.shape[0]], axis=0)
    print(f"  in  [{n}, {channels}] time-major rows")
    print(f"  out [{yt.shape[0]}, {yt.shape[1]}] rows on "
          f"{list(yt.devices())[0].platform} (zero host syncs)")


if __name__ == "__main__":
    print("HQ inter-phase mode (non-exact ratio 44.1k -> 48,001):")
    hq_interp_demo()
    print("Time-major device-resident serving (44.1k -> 48k, 8 ch):")
    time_major_demo()
