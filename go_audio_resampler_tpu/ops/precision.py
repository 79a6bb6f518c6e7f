"""Matmul precision tiers for the float32 hot paths.

Every banded matmul and convolution in the engines passes its
``precision`` through :func:`dot_precision`.  The tier names map onto
``lax.Precision``; what each runs as is the backend's choice (on an
NVIDIA Hopper card ``highest`` is float32 outside the tensor cores, while
``high`` and ``default`` may run in TF32 — ``chip_smoke.py`` establishes
which).  The default stays ``highest``: full float32 numerics, the tier
every quality floor is asserted at.  ``GAR_TPU_MATMUL_PRECISION`` selects
the process-wide tier; it is read at TRACE time, so toggling it after a
function compiled requires clearing that function's jit cache.
"""

from __future__ import annotations

import os

from jax import lax

_PRECISION_TIERS = {
    'default': lax.Precision.DEFAULT,
    'high': lax.Precision.HIGH,
    'highest': lax.Precision.HIGHEST,
}


#: Per-engine tier names: 'auto' defers to the process-global env var.
PRECISION_MODES = ('auto', 'highest', 'high', 'default')


def dot_precision(tier: str | None = None) -> lax.Precision:
    """Precision for the banded-matmul hot paths (see _PRECISION_TIERS).

    ``tier`` is an explicit per-call-site pin ('highest'/'high'/
    'default'); ``None`` (or 'auto') reads the process-global
    ``GAR_TPU_MATMUL_PRECISION`` at trace time.
    """
    if tier is not None and tier != 'auto':
        return _PRECISION_TIERS[tier.lower()]
    return _PRECISION_TIERS[
        os.environ.get('GAR_TPU_MATMUL_PRECISION', 'highest').lower()]
