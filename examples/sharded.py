"""Multi-device stream-parallel resampling example (beyond the Go reference).

Channels/streams are independent, so the framework scales across devices
with pure data parallelism: the stream batch axis is sharded over a
``jax.sharding.Mesh`` and every device runs the identical per-block
program (no collectives on the sample path).  The reference's analog is
goroutine-per-channel fan-out (constant.go:224-241); here it is one SPMD
device program.

Runs anywhere: on a multi-GPU host the mesh spans real devices; on a
single host you can simulate one with
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu

Run:  python examples/sharded.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
from jax.sharding import Mesh

from go_audio_resampler_tpu.engine import plan_engine
from go_audio_resampler_tpu.filterdesign import Quality
from go_audio_resampler_tpu.parallel import ShardedEngineCore, sharded_oneshot


def main():
    devices = np.asarray(jax.devices())
    mesh = Mesh(devices, ("streams",))
    print(f"mesh: {len(devices)} x {devices[0].platform}")

    plan = plan_engine(44100.0, 48000.0, Quality.HIGH)
    rng = np.random.default_rng(0)

    # One-shot: a batch of streams resampled in one sharded program.
    n_streams = 4 * len(devices)
    x = rng.normal(size=(n_streams, 44100)).astype(np.float32) * 0.5
    y = np.asarray(sharded_oneshot(plan, x, mesh))
    print(f"one-shot: {x.shape} -> {y.shape} "
          f"({n_streams} streams, {len(devices)} devices)")

    # Streaming: stateful engine whose step runs under shard_map.
    eng = ShardedEngineCore(plan, mesh, batch_per_device=2, block=2048)
    outs = [eng.process(x[: eng.batch, i:i + 4096])
            for i in range(0, 44100, 4096)]
    outs.append(eng.flush())
    ys = np.concatenate(outs, axis=1)
    print(f"streaming: {eng.batch} streams -> {ys.shape[1]} samples each")
    # Sharded streaming equals the one-shot canonical stream.
    m = min(ys.shape[1], y.shape[1])
    d = float(np.abs(ys[:, :m] - y[: eng.batch, :m]).max())
    print(f"sharded streaming vs one-shot maxdiff: {d:.2e}")
    assert d < 1e-4


if __name__ == "__main__":
    main()
