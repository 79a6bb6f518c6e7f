"""Roofline accounting for the banded-matmul hot paths.

Every timed device program in this framework is a banded periodic matmul
whose per-input-sample operation count is a *static compile-time
constant* — the [P2, Wx] matrix dims and the Ipx input stride per period
fully determine flops/sample and device-memory bytes/sample.  This module
turns a measured Msamples/s into

  - ``tflops_achieved``  — useful Tflop/s implied by the matrix dims,
  - ``flops_pct``        — that rate over the peak of the unit the
                           precision tier runs on (``TIER_UNIT``),
  - ``hbm_gbps`` / ``hbm_pct`` — bandwidth implied by the bytes model,
  - ``bound``            — ``"compute"`` when the operations take longer
                           at peak than the bytes, else ``"memory"``,
  - ``roofline_pct``     — the least time the card could take (the larger
                           of ops/peak and bytes/bandwidth) over the
                           measured time.

A wall-clock slope includes everything the step does; the per-kernel
shares come from a profiler trace, not from here.
"""

from __future__ import annotations

__all__ = [
    "PEAKS", "TIER_UNIT", "device_peaks", "banded_model", "general_model",
    "analyze",
]

#: Published dense peaks per ``jax.devices()[0].device_kind``: Tflop/s
#: per arithmetic unit and device-memory GB/s.  Source: NVIDIA H200 data
#: sheet (SXM part, dense rates without sparsity, at the 700 W limit):
#: 67 Tflop/s float32 outside the tensor cores, 495 TF32, 989 bf16,
#: 141 GB of HBM3e at 4.8 TB/s.  A card set below 700 W cannot hold
#: these under load; report its ``power.limit`` beside any share.
PEAKS = {
    "NVIDIA H200": {"fp32": 67.0, "tf32": 495.0, "bf16": 989.0,
                    "hbm_gbps": 4800.0},
}

#: Arithmetic unit each ``precision`` tier runs on (ops/precision.py).
#: ``highest`` is float32 outside the tensor cores; ``high`` and
#: ``default`` run as TF32 on the tensor cores, as ``chip_smoke.py``
#: phase 6 establishes on the card by matching each tier's product
#: bit for bit against the explicit dot-algorithm presets.
TIER_UNIT = {"highest": "fp32", "high": "tf32", "default": "tf32"}


def device_peaks(device=None) -> dict:
    """Peaks of ``device`` (default: ``jax.devices()[0]``).

    Returns ``{"kind", "fp32", "tf32", "bf16", "hbm_gbps"}``.  A device
    kind missing from :data:`PEAKS` is an error, never a default.
    """
    if device is None:
        import jax

        device = jax.devices()[0]
    kind = getattr(device, "device_kind", None)
    if kind not in PEAKS:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; add it to "
            f"utils/roofline.PEAKS (known: {sorted(PEAKS)})")
    return {"kind": kind, **PEAKS[kind]}


def banded_model(p2: int, wx: int, ipx: float, *,
                 read_amp: float | None = None, nnz: int | None = None,
                 bytes_elem: int = 4) -> dict:
    """Static per-input-sample op counts for a [P2 x Wx] banded step.

    One period consumes ``ipx`` input samples and emits ``p2`` outputs
    through a dense [Wx, P2] matmul (the matrix's structural zeros are
    executed, so they count as issued work; ``nnz`` when given
    additionally reports the truly-useful MAC fraction).  flops := 2*MACs.

    ``read_amp`` — device-memory reads of x per input sample.  The XLA
    gather+einsum lowering materializes overlapping frames, so the
    default is ``wx / ipx``.
    """
    if read_amp is None:
        read_amp = wx / ipx
    return {
        # ipx may be fractional for quasi-periodic walks (the general
        # non-exact path consumes tv * in_rate/out_rate inputs per tile).
        "p2": int(p2), "wx": int(wx), "ipx": float(ipx),
        "flops_per_in": 2.0 * p2 * wx / ipx,
        "nnz_flops_per_in": (2.0 * nnz / ipx) if nnz is not None else None,
        "bytes_per_in": bytes_elem * (read_amp + p2 / ipx),
    }


def general_model(*, factor: int, pre_taps: int, poly_taps: int,
                  num_phases: int, step_hi: int, block: int, poly_cap: int,
                  tile: int = 256) -> dict:
    """Static op model of the general (non-exact-rational) streaming step.

    The step is prestage conv (factor x pre_taps per input) followed by
    the polyphase emit: per tile of ``tile`` outputs one [S, span] x
    [span, tile] matmul in the banded lowering (stages._poly_emit_banded),
    where ``span`` is the static window-span bound from stages.poly_emit,
    plus the Horner coefficient interpolation (~6 * poly_taps
    flops/output).  The walk computes the full padded cap every block
    (invalid outputs are masked, not skipped), so computed outputs/input
    = roundup(poly_cap, tile) / block.

    The bytes model is per-stream and coarse (x once, u written+read,
    output written); the on-device banded-block assembly is
    batch-amortized and omitted.
    """
    def round_up(x: int, m: int) -> int:
        return -(-x // m) * m

    div_adv = ((tile - 1) * (step_hi + 1)) // num_phases + 1
    span = round_up(div_adv + poly_taps, 128)
    outs_per_in = round_up(poly_cap, tile) / block
    flops = (2.0 * factor * pre_taps + 2.0 * span * outs_per_in
             + 6.0 * poly_taps * outs_per_in)
    return {
        "p2": int(tile), "wx": int(span), "ipx": float(tile / outs_per_in),
        "flops_per_in": flops,
        "nnz_flops_per_in": None,
        "bytes_per_in": 4.0 * (1.0 + 2.0 * factor + outs_per_in),
    }


def analyze(msps: float, model: dict, tier: str = "highest",
            peaks: dict | None = None) -> dict:
    """Roofline verdict for a measured throughput.

    ``msps`` — measured Msamples/s (input samples); ``model`` — from
    :func:`banded_model` or :func:`general_model`; ``tier`` — matmul
    precision tier of the timed program ('highest' | 'high' | 'default').
    """
    peaks = peaks or device_peaks()
    unit = TIER_UNIT[tier]
    rate = msps * 1e6                                  # input samples / s
    tflops = rate * model["flops_per_in"] / 1e12
    gbps = rate * model["bytes_per_in"] / 1e9
    t_ops = model["flops_per_in"] / (peaks[unit] * 1e12)
    t_bytes = model["bytes_per_in"] / (peaks["hbm_gbps"] * 1e9)
    return {
        "tier": tier,
        "unit": unit,
        "tflops_achieved": tflops,
        "flops_pct": 100.0 * tflops / peaks[unit],
        "hbm_gbps": gbps,
        "hbm_pct": 100.0 * gbps / peaks["hbm_gbps"],
        "bound": "compute" if t_ops >= t_bytes else "memory",
        "roofline_pct": 100.0 * max(t_ops, t_bytes) * rate,
        "device": peaks["kind"],
    }
