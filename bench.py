"""Benchmark: input Msamples/s of the streaming steps on one GPU.

Prints one JSON line per row.  Each row chains a streaming step ``n``
blocks deep on the device with a dynamic-trip-count ``lax.fori_loop``,
so ONE compiled program gives the slope between two chain depths
(marginal samples / marginal time), which cancels the fixed launch and
host cost.  Every timing waits with ``block_until_ready``; each depth's
time is the minimum over interleaved repeats.

Rows (all through XLA's gather + einsum lowering):

- ``serving``        44.1k->48k HIGH, 1024 streams, block 2352, the
                     full-float32 tier (``precision='highest'``);
- ``ingest_tier``    the same step at ``precision='default'``;
- ``ml_ingest``      48k->16k integer decimation, 256 streams;
- ``general``        the non-exact 44.1k->48,001 walk, 256 streams.

Every line names the device (platform, kind, count), the card's power
limit, ``peak_bytes_in_use`` and a roofline verdict against the card's
published peaks (utils/roofline.py).  The script exits non-zero, and
prints no row, when JAX's default device is not a GPU.

Usage:  python bench.py [row ...]
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

ROWS = ("serving", "ingest_tier", "ml_ingest", "general")


def _power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.splitlines()[0].strip()


def chain_slope(core, st0, x, depths=(8, 264), repeats: int = 5) -> float:
    """Input Msamples/s of ``core`` chained on device (see module doc)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    @jax.jit
    def run(n, xx, st):
        def body(_, val):
            s, acc = val
            s2, y, _n = core(s, xx)
            return s2, acc + jnp.sum(y)
        return lax.fori_loop(0, n, body, (st, jnp.zeros((), xx.dtype)))[1]

    lo, hi = depths
    run(hi, x, st0).block_until_ready()            # compile + warm
    best = {lo: float("inf"), hi: float("inf")}
    for _ in range(repeats):
        for n in (lo, hi):
            t0 = time.perf_counter()
            run(n, x, st0).block_until_ready()
            best[n] = min(best[n], time.perf_counter() - t0)
    return (hi - lo) * x.shape[0] * x.shape[1] / (best[hi] - best[lo]) / 1e6


def main(argv=None) -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX default device is {dev.platform!r}); "
              "nothing was measured", file=sys.stderr)
        return 2
    import jax.numpy as jnp

    from go_audio_resampler_tpu.engine import EngineCore, plan_engine
    from go_audio_resampler_tpu.filterdesign import Quality
    from go_audio_resampler_tpu.utils import compile_cache
    from go_audio_resampler_tpu.utils.roofline import (
        analyze, banded_model, device_peaks, general_model)

    compile_cache.enable()
    wanted = (argv if argv is not None else sys.argv[1:]) or ROWS
    peaks = device_peaks(dev)
    card = _power_limit()
    rng = np.random.default_rng(0)

    def engine(inr, outr, streams, block, tier):
        plan = plan_engine(inr, outr, Quality.HIGH)
        return plan, EngineCore(plan, batch=streams, block=block,
                                dtype=jnp.float32, precision=tier)

    def emit(row, eng, msps, model, tier):
        stats = dev.memory_stats() or {}
        print(json.dumps({
            "row": row, "msamples_per_s": msps, "unit": "Msamples/s input",
            "streams": eng.batch, "block": eng.block, "tier": tier,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "nvidia_smi": card,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            "roofline": analyze(msps, model, tier=tier, peaks=peaks),
        }), flush=True)

    for row in wanted:
        if row in ("serving", "ingest_tier"):
            tier = "highest" if row == "serving" else "default"
            _plan, eng = engine(44100.0, 48000.0, 1024, 2352, tier)
            model = banded_model(eng._rational_p2, eng._rational_wx,
                                 eng._rational_ipx)
        elif row == "ml_ingest":
            tier = "highest"
            _plan, eng = engine(48000.0, 16000.0, 256, 2048, tier)
            model = banded_model(eng._decim_p2, eng._decim_wx,
                                 eng._decim_ipx)
        elif row == "general":
            tier = "highest"
            plan, eng = engine(44100.0, 48001.0, 256, 2048, tier)
            model = general_model(
                factor=plan.factor, pre_taps=plan.pre_taps,
                poly_taps=plan.poly_taps, num_phases=plan.num_phases,
                step_hi=plan.step_hi, block=eng.block, poly_cap=eng.poly_cap)
        else:
            raise SystemExit(f"unknown row {row!r}; rows: {ROWS}")
        x = jnp.asarray(rng.normal(size=(eng.batch, eng.block))
                        .astype(np.float32) * 0.5)
        msps = chain_slope(eng.core_fn(), eng._init_state(), x)
        emit(row, eng, msps, model, tier)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
