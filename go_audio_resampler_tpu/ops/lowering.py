"""Which lowering runs on which platform: the one module that asks.

Every trace-time choice between two lowerings of the same operation is
made here from the backend JAX will compile for, never from a user
option.  Callers read these at trace time.
"""

from __future__ import annotations

import jax


def conv_impl() -> str:
    """Default 1-D FIR lowering (ops/convolve.py).

    'frames' on the CPU, where XLA:CPU compiles long-kernel convolutions
    pathologically slowly; 'banded' (grouped-frames banded matmul)
    elsewhere.
    """
    return 'frames' if jax.default_backend() == 'cpu' else 'banded'


def banded_poly_emit() -> bool:
    """Streaming polyphase emit as a per-tile banded matmul
    (engine/stages._poly_emit_banded) instead of the per-output gather.

    On the GPU the banded form measured 1.6x the gather on the non-exact
    44.1k->48,001 walk (256 streams, NVIDIA H200); the CPU keeps the
    per-output gather, the reference the banded form is tested against.
    """
    return jax.default_backend() == 'gpu'
