"""Device-resident serving loop: resample -> ML ingest with zero host syncs.

The serving pattern the reference cannot express (it is a host-side Go
library): audio chunks arrive as device arrays, `process_device` runs
each chunk as ONE device launch whose output STAYS on device (output
counts are static, so no host synchronization happens anywhere), and the
consumer — here a toy feature extractor standing in for an ML model —
chains directly on the device arrays.  The host only orchestrates; the
samples never bounce through it.

Also shown: snapshotting the live stream mid-flight with
`save_stream_state` and resuming bit-identically in a fresh engine —
the serving-restart story (engine/checkpoint.py).

Run:  python examples/device_serving.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from go_audio_resampler_tpu.engine import (
    EngineCore, plan_engine, save_stream_state, load_stream_state)
from go_audio_resampler_tpu.filterdesign import Quality


@jax.jit
def toy_ingest(frames_16k):
    """Stand-in for a model front end: log-energy over 400-sample hops."""
    n = (frames_16k.shape[1] // 400) * 400
    w = frames_16k[:, :n].reshape(frames_16k.shape[0], -1, 400)
    return jnp.log1p(jnp.sum(w * w, axis=-1))


def main():
    # 64 concurrent 48 kHz streams -> 16 kHz model rate.
    plan = plan_engine(48000.0, 16000.0, Quality.HIGH)
    eng = EngineCore(plan, batch=64, block=4096, dtype=np.float32)
    mult = eng.device_chunk_multiple
    chunk = (48000 // mult) * mult          # ~1 s of audio per call
    print(f"chunk multiple {mult}, serving {chunk}-sample chunks")

    rng = np.random.default_rng(0)
    feats = []
    for step in range(5):
        # In production this device array comes straight from the data
        # pipeline; nothing below synchronizes with the host.
        x = jnp.asarray(rng.standard_normal((64, chunk), np.float32) * 0.3)
        y16 = eng.process_device(x)         # one launch, stays on device
        feats.append(toy_ingest(y16))       # chained device work

        if step == 2:
            # Snapshot the live stream (host-side by nature); a restarted
            # process resumes bit-identically from the file.
            save_stream_state(eng, "/tmp/serving_ckpt.npz")
            print("checkpointed mid-stream at step 2")

    tail = eng.flush_device()
    feats.append(toy_ingest(tail))
    total = sum(int(f.shape[1]) for f in feats)
    print(f"served {total} feature frames x 64 streams "
          f"(first values {np.asarray(feats[0][0, :3]).round(3)})")

    # Restart drill: a fresh engine resumes from the snapshot and emits
    # exactly what the original would have from step 3 on.
    eng2 = EngineCore(plan, batch=64, block=4096, dtype=np.float32)
    load_stream_state(eng2, "/tmp/serving_ckpt.npz")
    print(f"resumed: samples_in={eng2.samples_in}, "
          f"samples_out={eng2.samples_out}")

    # Host-consumer variant: when the output must land in numpy (file
    # writers, non-JAX consumers), the pipelined generator overlaps the
    # device->host download of chunk k with chunk k+1's device compute
    # (EngineCore.stream, one-chunk download lag) — no threads, just
    # async dispatch.
    eng3 = EngineCore(plan, batch=64, block=4096, dtype=np.float32)
    chunks = (rng.standard_normal((64, chunk)).astype(np.float32) * 0.3
              for _ in range(3))
    n_out = sum(y.shape[1] for y in eng3.stream(chunks))
    print(f"pipelined host stream: {n_out} samples x 64 streams")


if __name__ == "__main__":
    main()
