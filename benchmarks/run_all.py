"""Full benchmark matrix: the five BASELINE.json configurations plus the
streaming serving path.

Usage: python benchmarks/run_all.py [config-substring ...] — with args,
only matching configs run and results merge into results.json.

Writes benchmarks/results.json (not committed: results belong to the card
and the run that made them) and prints one line per config, each naming
the device, its power limit and peak device memory.  Uses the slope
method (marginal samples / marginal time between two batch sizes or chain
depths) to cancel the fixed per-call launch and host cost; every timing
waits with ``block_until_ready``.  Exits non-zero, measuring nothing, when
JAX's default device is not a GPU.

Configs (BASELINE.json):
  1. one-shot mono 44.1k->48k QualityHigh (1 s sine)
  2. stereo streaming 48k->44.1k float32
  3. quality preset sweep Quick -> VeryHigh (44.1k->48k)
  4. 8-channel 96k->48k (surround hot path)
  5. 256 concurrent mono streams 48k->16k (ML ingest)
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

# Runnable as `python benchmarks/run_all.py` from anywhere: sys.path[0] is
# this file's directory, so add the repo root for the package import.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def min_time(fn, iters=15):
    """Minimum wall time of ``fn()`` after a warm-up call, waiting for
    its device results."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.min(ts))


def slope_msps(make_fn, s_small, s_large, n):
    """Marginal Msamples/s between two batch sizes.

    The size contrast must be large enough that the time delta clearly
    exceeds the per-call jitter; otherwise the result is reported as a
    lower bound from the large size alone.
    """
    f_small = make_fn(s_small)
    f_large = make_fn(s_large)
    t_small = min_time(f_small)
    t_large = min_time(f_large)
    dt = t_large - t_small
    print(f"    [t({s_small})={t_small*1e3:.1f}ms t({s_large})="
          f"{t_large*1e3:.1f}ms]", flush=True)
    if dt < 0.002:  # delta below jitter floor: quote throughput at large size
        return s_large * n / t_large / 1e6
    return (s_large - s_small) * n / dt / 1e6


def roofline_annotations(results: dict) -> dict:
    """Roofline fields for the device-step rows (utils/roofline.py).

    Each timed device program is a banded matmul with static dims, so a
    measured Msamples/s converts to achieved Tflop/s, its share of the
    tier's unit peak, implied device-memory GB/s, and the bound
    (operations or bytes).  Host-inclusive rows (pipeline_*,
    streaming_e2e_*, streaming_pipelined_*) include host work and
    transfers and get no roofline.
    """
    from go_audio_resampler_tpu.engine import plan_engine
    from go_audio_resampler_tpu.engine.oneshot import (
        _decim_matrix, _fused_rational_matrix)
    from go_audio_resampler_tpu.filterdesign import Quality
    from go_audio_resampler_tpu.utils.roofline import (
        analyze, banded_model, device_peaks, general_model)

    peaks = device_peaks()
    out = {}

    def put(row, model, tier):
        if results.get(row):
            out[row] = analyze(results[row], model, tier=tier, peaks=peaks)

    plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
    r, p2, ipx, _lam = _fused_rational_matrix(plan)
    m_serving = banded_model(p2, r.shape[1], ipx)
    put("streaming_44k_48k_fused_step", m_serving, "highest")
    put("streaming_fused_step_fast_tier", m_serving, "high")
    put("streaming_fused_step_ingest_tier", m_serving, "default")

    if results.get("ml_ingest_256x_48k_16k"):
        plan_d = plan_engine(48000.0, 16000.0, Quality.HIGH)
        rd, pd, ipxd = _decim_matrix(plan_d)
        put("ml_ingest_256x_48k_16k",
            banded_model(pd, rd.shape[1], ipxd), "highest")

    if results.get("streaming_general_step_44k_48k001"):
        from go_audio_resampler_tpu.engine.streaming import EngineCore
        plan_g = plan_engine(44100.0, 48001.0, Quality.HIGH)
        eng_g = EngineCore(plan_g, batch=1, block=2048)
        put("streaming_general_step_44k_48k001",
            general_model(factor=plan_g.factor, pre_taps=plan_g.pre_taps,
                          poly_taps=plan_g.poly_taps,
                          num_phases=plan_g.num_phases,
                          step_hi=plan_g.step_hi, block=eng_g.block,
                          poly_cap=eng_g.poly_cap), "highest")

    for in_rate, row in ((48000, "pipeline_fused_step_48k_8k"),
                         (192000, "pipeline_fused_step_192k_8k")):
        if results.get(row):
            import go_audio_resampler_tpu as gar
            rr = gar.new_resampler(gar.Config(
                in_rate, 8000, channels=1, max_input_size=8192,
                quality=gar.get_preset_spec(gar.QualityPreset.HIGH),
                dtype=np.float32))
            eng = rr._fused
            if eng is not None:
                put(row, banded_model(eng._banded_p2, eng._banded_wx,
                                      eng._banded_ipx), "highest")
    return out


def main() -> None:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"run_all: no GPU (JAX default device is {dev.platform!r}); "
              "nothing was measured", file=sys.stderr)
        raise SystemExit(2)
    from go_audio_resampler_tpu.utils import compile_cache
    compile_cache.enable()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.splitlines()[0].strip()
    import jax.numpy as jnp
    from go_audio_resampler_tpu.engine import plan_engine
    from go_audio_resampler_tpu.engine.oneshot import (_oneshot_jit,
                                                       _oneshot_aux)
    from go_audio_resampler_tpu.filterdesign import Quality

    only = sys.argv[1:]

    def wanted(name):
        return not only or any(o in name for o in only)

    rng = np.random.default_rng(0)
    results = {}

    def oneshot_bench(inr, outr, q, n, s_small, s_large, dtype='float32'):
        plan = plan_engine(float(inr), float(outr), q)

        def make(s):
            # x and the host-prepared aux (general-path banded matrices)
            # are passed as jit ARGUMENTS: captured arrays would be baked
            # into the program as constants.
            x = jnp.asarray(rng.normal(size=(s, n)).astype(np.float32) * 0.5)
            aux = _oneshot_aux(plan, n, np.dtype(dtype))
            g = jax.jit(lambda xx, *a: jnp.sum(
                _oneshot_jit(plan, xx, dtype, *a)))
            return lambda: g(x, *aux)
        return slope_msps(make, s_small,
                          s_large, n)

    # 1. one-shot mono 44.1k->48k High
    if wanted("oneshot_mono_44k_48k_high"):
        results["oneshot_mono_44k_48k_high"] = oneshot_bench(
            44100, 48000, Quality.HIGH, 44100, 128, 2048)

    # 2. "stereo streaming" 48k->44.1k: 2-lane batches
    if wanted("stereo_48k_44k_high_f32"):
        results["stereo_48k_44k_high_f32"] = oneshot_bench(
            48000, 44100, Quality.HIGH, 48000, 128, 2048)

    # 3. preset sweep at 44.1k->48k
    for q, name in [(Quality.QUICK, "quick"), (Quality.LOW, "low"),
                    (Quality.MEDIUM, "medium"), (Quality.HIGH, "high"),
                    (Quality.VERY_HIGH, "veryhigh")]:
        if wanted(f"sweep_{name}"):
            results[f"sweep_{name}"] = oneshot_bench(
                44100, 48000, q, 44100, 128, 2048)

    # 4. 8-channel surround 96k->48k (integer decimation path)
    if wanted("surround_8ch_96k_48k"):
        results["surround_8ch_96k_48k"] = oneshot_bench(
            96000, 48000, Quality.HIGH, 96000, 64, 1024)

    # 5. ML ingest: 256 concurrent mono streams 48k->16k
    if wanted("ml_ingest_256x_48k_16k"):
        results["ml_ingest_256x_48k_16k"] = oneshot_bench(
            48000, 16000, Quality.HIGH, 48000, 128, 2048)

    # 5b. hi-res upsampling 48k->96k (dft_up topology: the banded-matmul
    # prestage is the whole pipeline)
    if wanted("hires_up_48k_96k"):
        results["hires_up_48k_96k"] = oneshot_bench(
            48000, 96000, Quality.HIGH, 48000, 128, 2048)

    # 6. streaming serving path: fused per-block step, 16 blocks chained
    # on-device (slope between batch sizes cancels launch overhead)
    def fused_step_slope(n_steps: int = 64, precision: str = 'highest'):
        from go_audio_resampler_tpu.engine.streaming import _step_rational_fused
        import importlib
        osmod = importlib.import_module(
            'go_audio_resampler_tpu.engine.oneshot')
        plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
        r, p2, ipx, _lam = osmod._fused_rational_matrix(plan)
        rt = jnp.asarray(r.T, dtype=jnp.float32)
        wx = r.shape[1]
        blk = 16 * ipx
        carry_len = -(-max(wx - ipx, 0) // ipx) * ipx

        def make(s):
            x = jnp.asarray(rng.normal(size=(s, blk)).astype(np.float32))

            @jax.jit
            def g(xx):
                def body(carry, _):
                    c, acc = carry
                    c2, y, n = _step_rational_fused(rt, c, xx, ipx=ipx,
                                                    wx=wx, p2=p2,
                                                    precision=precision)
                    return (c2, acc + jnp.sum(y)), None
                init = (jnp.zeros((s, carry_len), jnp.float32),
                        jnp.float32(0))
                (c, acc), _ = jax.lax.scan(body, init, None, length=n_steps)
                return acc
            return lambda: g(x)
        return slope_msps(lambda s: make(s), 128,
                          1024, blk * n_steps)

    if wanted("streaming_44k_48k_fused_step"):
        results["streaming_44k_48k_fused_step"] = fused_step_slope()

    # 6b/6c. the same serving step at the reduced-precision tiers
    # (ops/precision.py).  The ingest tier's chain is 8x deeper so the
    # contrast stays well above the per-call jitter at its higher rate.
    if wanted("streaming_fused_step_fast_tier"):
        results["streaming_fused_step_fast_tier"] = fused_step_slope(
            precision="high")
    if wanted("streaming_fused_step_ingest_tier"):
        results["streaming_fused_step_ingest_tier"] = fused_step_slope(
            n_steps=512, precision="default")

    # 7. non-exact-rational general path: gather+einsum polyphase (the
    # fused periodic matmul does not apply; 44.1k->48.001k has no small
    # exact rational form)
    if wanted("general_gather_44k_48k001"):
        results["general_gather_44k_48k001"] = oneshot_bench(
            44100, 48001, Quality.HIGH, 44100, 128, 2048)

    # 7b. STREAMING general path: the same non-exact ratio through
    # EngineCore's per-block step (stages.poly_process two-limb walk +
    # tiled gather/einsum emit) chained on-device — the streaming
    # counterpart of config 7 (whose per-(plan,length) tile matrices do
    # not apply to a stateful stream).
    if wanted("streaming_general_step_44k_48k001"):
        from go_audio_resampler_tpu.engine.streaming import EngineCore

        plan_g = plan_engine(44100.0, 48001.0, Quality.HIGH)
        # DEPTH contrast (8 vs 136 chained steps at fixed batch), same
        # methodology as bench.chain_slope: a stream-count contrast
        # quotes the marginal per-stream cost and hides any
        # batch-independent serial cost per step, while a depth contrast
        # charges every per-step cost to the slope.
        s_streams = 256
        eng_g = EngineCore(plan_g, batch=s_streams, block=2048,
                           dtype=jnp.float32)
        st0_g = eng_g._init_state()
        f_g = eng_g.core_fn()
        x_g = jnp.asarray(rng.normal(
            size=(s_streams, eng_g.block)).astype(np.float32))

        @jax.jit
        def g_depth(n):
            def body(_, val):
                st, acc = val
                st2, y, n_ = f_g(st, x_g)
                return (st2, acc + jnp.sum(y))
            return jax.lax.fori_loop(
                0, n, body, (st0_g, jnp.float32(0)))[1]

        def make_general_depth(n):
            return lambda: g_depth(n)
        results["streaming_general_step_44k_48k001"] = slope_msps(
            make_general_depth, 8, 136, s_streams * eng_g.block)

    # 8. pipeline path: api.Resampler multi-stage half-band chain
    # (48k->8k = 2x half-band + 2/3 polyphase), including the per-stage
    # host orchestration cost
    if wanted("pipeline_48k_8k_high"):
        import go_audio_resampler_tpu as gar
        n = 48000

        def make_pipeline(s):
            # max_input_size 16384 -> a ~22k fused block: every
            # 48000-sample call runs >= 2 device blocks, so the
            # min-of-15 statistic always times real work (with one huge
            # block, calls alternate between zero and one block and the
            # minimum is meaningless), while launches stay few.
            r = gar.new_resampler(gar.Config(
                48000, 8000, channels=s, max_input_size=16384,
                quality=gar.get_preset_spec(gar.QualityPreset.HIGH),
                dtype=np.float32))
            chans = [rng.normal(size=n).astype(np.float32) * 0.5
                     for _ in range(s)]

            def f():
                out = r.process_multi(chans)
                return float(np.asarray(out[0][:1]).sum())
            return f
        results["pipeline_48k_8k_high"] = slope_msps(
            make_pipeline, 8, 64, n)

    # 8b. deep pipeline chain: 192k->8k (ratio 1/24 = 4 half-bands + 2/3
    # residual) through the fused composite banded operator.
    if wanted("pipeline_192k_8k_high"):
        import go_audio_resampler_tpu as gar
        n = 192000

        def make_pipeline_deep(s):
            r = gar.new_resampler(gar.Config(
                192000, 8000, channels=s, max_input_size=16384,
                quality=gar.get_preset_spec(gar.QualityPreset.HIGH),
                dtype=np.float32))
            chans = [rng.normal(size=n).astype(np.float32) * 0.5
                     for _ in range(s)]

            def f():
                out = r.process_multi(chans)
                return float(np.asarray(out[0][:1]).sum())
            return f
        results["pipeline_192k_8k_high"] = slope_msps(
            make_pipeline_deep, 8, 32, n)

    # 8d. fused-pipeline serving step: the composite banded operator's
    # device step chained on-device (same methodology as the headline
    # streaming_44k_48k_fused_step — the host-inclusive entries above
    # include host work and transfers).
    # Two chain depths: 48k->8k (2 half-bands + 2/3 residual) and
    # 192k->8k (4 half-bands + 2/3 residual, W/I ~ 1200).
    for in_rate, name in ((48000, "pipeline_fused_step_48k_8k"),
                          (192000, "pipeline_fused_step_192k_8k")):
      if wanted(name):
        import go_audio_resampler_tpu as gar
        from go_audio_resampler_tpu.engine.streaming import \
            _fused_banded_step
        r = gar.new_resampler(gar.Config(
            in_rate, 8000, channels=1, max_input_size=8192,
            quality=gar.get_preset_spec(gar.QualityPreset.HIGH),
            dtype=np.float32))
        eng = r._fused
        assert eng is not None
        rt, ipx, wx, p2 = (eng._banded_rt, eng._banded_ipx,
                           eng._banded_wx, eng._banded_p2)
        carry_len = eng._banded_carry
        blk = eng.block
        # 64 chained steps and a 64->512 stream contrast keep the time
        # delta well above the per-call jitter.
        n_steps = 64

        def make_fused_pipe(s):
            x = jnp.asarray(rng.normal(size=(s, blk)).astype(np.float32))

            @jax.jit
            def g(xx):
                def body(carry, _):
                    c, acc = carry
                    c2, y, n_ = _fused_banded_step(rt, c, xx, ipx=ipx,
                                                   wx=wx, p2=p2)
                    return (c2, acc + jnp.sum(y)), None
                init = (jnp.zeros((s, carry_len), jnp.float32),
                        jnp.float32(0))
                (c, acc), _ = jax.lax.scan(body, init, None,
                                           length=n_steps)
                return acc
            return lambda: g(x)
        results[name] = slope_msps(
            make_fused_pipe, 64, 512,
            blk * n_steps)

    # 8c. end-to-end streaming: host-inclusive EngineCore.process at
    # realistic block sizes (whole-system companion to the fused-step
    # kernel number: includes the host FIFO, chunking, device dispatch
    # and output download).
    for blk in (2048, 8192):
        if wanted(f"streaming_e2e_44k_48k_b{blk}"):
            from go_audio_resampler_tpu.engine import EngineCore
            plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
            n = 44100

            def make_e2e(s, blk=blk):
                eng = EngineCore(plan, batch=s, block=blk, dtype=np.float32)
                x = rng.normal(size=(s, n)).astype(np.float32) * 0.5

                def f():
                    out = eng.process(x)
                    return float(out[0, :1].sum()) if out.size else 0.0
                return f
            results[f"streaming_e2e_44k_48k_b{blk}"] = slope_msps(
                make_e2e, 32, 256, n)

    # 8e. DEVICE-RESIDENT end-to-end streaming: the same host-driven loop
    # as 8c, but through EngineCore.process_device — input chunks are
    # device arrays, outputs stay device arrays, and the wrapper never
    # syncs (static output counts).  Marginal cost per chunk is the async
    # dispatch plus the device step; the gap vs
    # streaming_44k_48k_fused_step is host dispatch, not data bounce.
    if wanted("streaming_device_e2e_44k_48k"):
        from go_audio_resampler_tpu.engine import EngineCore
        plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
        s_d = 512
        eng_d = EngineCore(plan, batch=s_d, block=2048, dtype=np.float32)
        mult = eng_d.device_chunk_multiple
        chunk = (44100 // mult) * mult       # ~1 s of audio per call

        def make_dev(k_chunks):
            xs = [jax.device_put(
                rng.normal(size=(s_d, chunk)).astype(np.float32))
                for _ in range(k_chunks)]

            def f():
                y = None
                for x in xs:          # one launch per chunk, no sync
                    y = eng_d.process_device(x)
                return float(jnp.sum(y[:, :1]))   # orders all launches
            return f
        t2 = min_time(make_dev(2))
        t8 = min_time(make_dev(8))
        dt = t8 - t2
        print(f"    [t(2)={t2*1e3:.1f}ms t(8)={t8*1e3:.1f}ms]", flush=True)
        if dt < 0.002:
            results["streaming_device_e2e_44k_48k"] = \
                8 * s_d * chunk / t8 / 1e6
        else:
            results["streaming_device_e2e_44k_48k"] = \
                6 * s_d * chunk / dt / 1e6

    # 8f. PIPELINED host e2e: numpy in -> numpy out through
    # EngineCore.stream(), which dispatches chunk k+1 before downloading
    # chunk k so the device->host transfer rides under the next chunk's
    # compute (ROADMAP 13).  Same host-inclusive loop as 8c — the delta
    # vs streaming_e2e_* is purely the overlap.
    if wanted("streaming_pipelined_e2e_44k_48k"):
        from go_audio_resampler_tpu.engine import EngineCore
        plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
        # Modest geometry on purpose: this row measures the HOST loop
        # (upload + compute + download per chunk, one-chunk lag), so the
        # timed call moves k * s * chunk * 4 bytes each way between host
        # and device; 64 streams x ~1 s keeps one iteration ~11 MB/dir.
        s_p = 64
        eng_p = EngineCore(plan, batch=s_p, block=2048, dtype=np.float32)
        chunk_p = 44100

        def make_pipe(k_chunks):
            xs = [rng.normal(size=(s_p, chunk_p)).astype(np.float32)
                  for _ in range(k_chunks)]

            def f():
                eng_p.reset()
                tot = 0
                for y in eng_p.stream(xs):
                    tot += y.shape[1]
                return tot
            return f
        # Paired serial twin: the SAME device-mode launches (shared jit
        # cache) but with the download forced right after each dispatch —
        # isolates exactly what the one-chunk lag buys.
        def make_serial(k_chunks):
            xs = [rng.normal(size=(s_p, chunk_p)).astype(np.float32)
                  for _ in range(k_chunks)]

            def f():
                eng_p.reset()
                tot = 0
                for x in xs:
                    y = np.asarray(eng_p.process_device(jnp.asarray(x)))
                    tot += y.shape[1]
                tot += np.asarray(eng_p.flush_device()).shape[1]
                return tot
            return f

        def chunk_slope(mk, name):
            t2 = min_time(mk(2), iters=8)
            t6 = min_time(mk(6), iters=8)
            dt = t6 - t2
            print(f"    [{name} t(2)={t2*1e3:.1f}ms t(6)={t6*1e3:.1f}ms]",
                  flush=True)
            if dt < 0.002:
                return 6 * s_p * chunk_p / t6 / 1e6
            return 4 * s_p * chunk_p / dt / 1e6

        results["streaming_serial_device_e2e_44k_48k"] = \
            chunk_slope(make_serial, "serial")
        results["streaming_pipelined_e2e_44k_48k"] = \
            chunk_slope(make_pipe, "pipelined")

    # 8g. TRANSPORT microbenchmark: raw host->device / device->host
    # bandwidth, measured min-of-N on a size
    # slope (cancels the fixed per-call latency, same discipline as every
    # other row).  The host e2e rows above are claimed transport-bound;
    # this row turns that from prose into data — results.json carries the
    # measured MB/s and the DERIVED Ms/s ceiling for the pipelined loop
    # (4 B/sample up + 4*ratio B/sample down, f32), so the gap between
    # streaming_pipelined_e2e_44k_48k and its ceiling is inspectable.
    transport = {}
    if wanted("transport"):
        small_b, large_b = 4 << 20, 36 << 20

        def t_up(nbytes):
            a = rng.normal(size=nbytes // 4).astype(np.float32)
            ts = []
            for _ in range(8):
                t0 = time.perf_counter()
                jax.block_until_ready(jax.device_put(a))
                ts.append(time.perf_counter() - t0)
            return float(np.min(ts))

        def t_down(nbytes):
            # Distinct device arrays per iteration: jax.Array caches its
            # host copy after the first download, so re-downloading one
            # array would time the cache, not the link.
            base = jax.device_put(
                rng.normal(size=nbytes // 4).astype(np.float32))
            ds = [jax.block_until_ready(base + np.float32(i))
                  for i in range(8)]
            ts = []
            for d in ds:
                t0 = time.perf_counter()
                np.asarray(d)
                ts.append(time.perf_counter() - t0)
            return float(np.min(ts))

        d_mb = (large_b - small_b) / 1e6
        up_mbps = d_mb / max(t_up(large_b) - t_up(small_b), 1e-9)
        down_mbps = d_mb / max(t_down(large_b) - t_down(small_b), 1e-9)
        ratio = 48000.0 / 44100.0
        # Serial ceiling: every input sample moves 4 B up then 4*ratio B
        # down.  Overlapped ceiling: the pipelined loop hides the slower
        # direction under compute+the other direction at best, so the
        # bound is the busier single direction.
        serial = 1.0 / (4.0 / (up_mbps * 1e6)
                        + 4.0 * ratio / (down_mbps * 1e6)) / 1e6
        overlapped = min(up_mbps * 1e6 / 4.0,
                         down_mbps * 1e6 / (4.0 * ratio)) / 1e6
        transport = {
            "upload_MBps": round(up_mbps, 1),
            "download_MBps": round(down_mbps, 1),
            "e2e_44k_48k_f32_ceiling_serial_msps": round(serial, 2),
            "e2e_44k_48k_f32_ceiling_overlapped_msps": round(overlapped, 2),
        }
        print(f"    [transport up={up_mbps:.0f} MB/s down={down_mbps:.0f} "
              f"MB/s -> e2e ceiling serial={serial:.1f} "
              f"overlapped={overlapped:.1f} Ms/s]", flush=True)

    # 9. FFT overlap-save vs banded-matmul decimation (paired): the FFT
    # lowering's throughput is length-independent; the matmul path wins
    # at production prototype lengths (see engine/fftstage.py docstring).
    if wanted("fft_vs_matmul_96k_48k"):
        from go_audio_resampler_tpu.engine.fftstage import _fft_oneshot_jit

        plan = plan_engine(96000.0, 48000.0, Quality.HIGH)

        def make_fft(s):
            x = jnp.asarray(rng.normal(size=(s, 96000)).astype(np.float32))
            g = jax.jit(lambda xx: jnp.sum(_fft_oneshot_jit(plan, xx,
                                                            'float32')))
            return lambda: g(x)
        results["fft_decim_96k_48k"] = slope_msps(
            make_fft, 64, 512, 96000)

    # 9b. LONG-prototype decimation, FFT vs matmul paired A/B at 48k->4k
    # VeryHigh (6403 taps) — the measurement behind DECIM_FFT_MIN_TAPS
    # (engine/oneshot.py).  Each leg pins the crossover so both
    # lowerings are measured regardless of the default.
    if wanted("decim_long"):
        import importlib
        osm = importlib.import_module('go_audio_resampler_tpu.engine.oneshot')
        plan_l = plan_engine(48000.0, 4000.0, Quality.VERY_HIGH)
        n = 48000

        def run_decim_long(thresh):
            saved = osm.DECIM_FFT_MIN_TAPS
            osm.DECIM_FFT_MIN_TAPS = thresh
            osm._oneshot_jit.clear_cache()
            try:
                def make(s):
                    x = jnp.asarray(
                        rng.normal(size=(s, n)).astype(np.float32) * 0.5)
                    g = jax.jit(lambda xx: jnp.sum(
                        osm._oneshot_jit(plan_l, xx, 'float32')))
                    return lambda: g(x)
                return slope_msps(make, 64,
                                  512, n)
            finally:
                osm.DECIM_FFT_MIN_TAPS = saved
                osm._oneshot_jit.clear_cache()
        results["decim_long_fft_48k_4k_vhq"] = run_decim_long(0)
        results["decim_long_matmul_48k_4k_vhq"] = run_decim_long(1 << 30)

    # 10. variable-rate serving: device-side throughput of the VR scan
    # (walk arrays precomputed, inputs device-resident, slope between two
    # scan lengths cancels the fixed per-call cost — same methodology as
    # every other config).
    if wanted("variable_rate_256x"):
        from go_audio_resampler_tpu.engine.variable import (
            VariableRateResampler, _vr_scan)
        s_b = 256
        blk = 8192
        vr = VariableRateResampler(2.0, 44100 / 48000, batch=s_b,
                                   block=blk, dtype=np.float32)
        vr.set_io_ratio(1.1, slew_len=1 << 30)

        def make_vr(k_blocks):
            from go_audio_resampler_tpu.engine.variable import VR_TILE
            vr.reset()
            vr.set_io_ratio(1.1, slew_len=1 << 30)
            walks = [vr._walk_block(float('inf')) for _ in range(k_blocks)]
            span = 8
            for idx_w, _f, _v, n_w in walks:
                for t in range(0, n_w, VR_TILE):
                    hi = idx_w[min(n_w, t + VR_TILE) - 1]
                    span = max(span, int(hi - idx_w[t]) + 4)
            span = -(-span // 128) * 128
            idx = jnp.asarray(np.stack([w[0] for w in walks]))
            fr = jnp.asarray(np.stack([w[1] for w in walks]),
                             dtype=np.float32)
            va = jnp.asarray(np.stack([w[2] for w in walks]))
            xs = jnp.asarray(rng.normal(
                size=(k_blocks, s_b, blk)).astype(np.float32))
            carry = jnp.zeros((s_b, 3), np.float32)
            pre = jnp.zeros((s_b, 0), np.float32)
            coeffs = jnp.zeros((1, 1), np.float32)

            def f():
                c2, p2_, ys = _vr_scan(carry, pre, coeffs, xs, idx, fr,
                                       va, factor=1, span=span)
                return jnp.sum(ys[-1, :, :1])
            return jax.jit(f)
        t4 = min_time(make_vr(4))
        t16 = min_time(make_vr(16))
        dt = max(t16 - t4, 1e-4)
        results["variable_rate_256x"] = 12 * s_b * blk / dt / 1e6

    stats = dev.memory_stats() or {}
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    for k, v in results.items():
        print(f"{k}: {v:.1f} Msamples/s  [{dev.device_kind} x"
              f"{device['count']}, {card}, peak_bytes_in_use="
              f"{stats.get('peak_bytes_in_use')}]")
    out = pathlib.Path(__file__).parent / "results.json"
    merged = {"results": {}, "roofline": {}, "transport": {}}
    if out.exists():
        prev = json.loads(out.read_text())
        if prev.get("device") == device:     # never mix cards in one file
            merged = {k: prev.get(k, {}) for k in merged}
    merged["results"].update(results)
    merged["roofline"].update(roofline_annotations(results))
    merged["transport"].update(transport)
    out.write_text(json.dumps(
        {"unit": "Msamples/s input throughput per device",
         "device": device, "nvidia_smi": card, **merged}, indent=2))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
