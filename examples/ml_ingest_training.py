"""Resample-as-a-layer: gradients through the resampler in a training step.

The reference is a host-side library — it cannot sit inside a compiled
training program.  Here `gar.resample` (go_audio_resampler_tpu/functional.py)
is a pure, differentiable JAX op, so a 48 kHz -> 16 kHz ingest stage can
live INSIDE the jitted train step and backpropagate into a learned
front end that runs at the raw rate.

The toy model: a learnable 48 kHz pre-emphasis FIR -> resample to 16 kHz
(QualityHigh) -> linear feature head.  Both parameter groups train
through the resampler's exact transposed-operator VJP.

Run:  python examples/ml_ingest_training.py        (CPU or GPU)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

import go_audio_resampler_tpu as gar

RATE_IN, RATE_OUT = 48000.0, 16000.0
N_IN = 4800                       # 100 ms of 48 kHz audio per clip
BATCH = 8
FIR_TAPS = 31
N_OUT = gar.functional.output_length(N_IN, RATE_IN, RATE_OUT,
                                     gar.QualityPreset.HIGH)
FEATS = 16


def forward(params, x48):
    """x48 [B, N_IN] -> features [B, FEATS]."""
    # Learned pre-emphasis at the RAW rate (what the gradient must reach
    # through the resampler).
    fir = params["fir"]
    xf = jax.vmap(lambda r: jnp.convolve(r, fir, mode="same"))(x48)
    # Differentiable 3:1 decimation with the production HIGH filter.
    x16 = gar.resample(xf, RATE_IN, RATE_OUT,
                       quality=gar.QualityPreset.HIGH)
    # Linear feature head at 16 kHz.
    return x16 @ params["head"]


def loss_fn(params, x48, target):
    pred = forward(params, x48)
    return jnp.mean((pred - target) ** 2)


@jax.jit
def train_step(params, x48, target, lr=0.05):
    loss, grads = jax.value_and_grad(loss_fn)(params, x48, target)
    params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
    return params, loss


def main():
    rng = np.random.default_rng(0)
    # Synthetic task: the "true" front end is a band-emphasis FIR the
    # model must recover through the resampler.
    t = np.arange(FIR_TAPS) - FIR_TAPS // 2
    true_fir = (np.sinc(t / 3.0) * np.hanning(FIR_TAPS)).astype(np.float32)
    true_head = rng.normal(size=(N_OUT, FEATS)).astype(np.float32) * 0.02

    def make_batch():
        x = rng.normal(size=(BATCH, N_IN)).astype(np.float32)
        xf = np.stack([np.convolve(r, true_fir, mode="same") for r in x])
        y16 = np.asarray(gar.resample(jnp.asarray(xf), RATE_IN, RATE_OUT,
                                      quality=gar.QualityPreset.HIGH))
        return jnp.asarray(x), jnp.asarray(y16 @ true_head)

    params = {
        "fir": jnp.zeros(FIR_TAPS, jnp.float32).at[FIR_TAPS // 2].set(1.0),
        "head": jnp.asarray(true_head),   # head known; learn the FIR
    }

    x0, y0 = make_batch()
    l0 = float(loss_fn(params, x0, y0))
    for step in range(40):
        x, y = make_batch()
        params, loss = train_step(params, x, y)
    l1 = float(loss)
    print(f"loss: {l0:.6f} -> {l1:.6f} over 40 steps "
          f"(gradients flowed through the HIGH-quality resampler)")
    assert l1 < 0.2 * l0, (l0, l1)

    # The learned FIR should approach the true band emphasis.
    err = float(jnp.linalg.norm(params["fir"] - true_fir)
                / np.linalg.norm(true_fir))
    print(f"recovered 48 kHz FIR, relative error {err:.3f}")


if __name__ == "__main__":
    main()
