"""Convenience API: direct-engine wrappers, one-shots, interleave helpers.

Counterpart of the reference's convenience.go:

- rate constants                    <-> convenience.go:11-41
- ``new_cd_to_dat`` etc.            <-> convenience.go:43-113
- ``SimpleResampler`` (float64)     <-> convenience.go:115-200
- ``SimpleResamplerFloat32``        <-> convenience.go:296-395
- ``resample_mono`` / ``_stereo``   <-> convenience.go:202-257, 397-457
- interleave/deinterleave helpers   <-> convenience.go:259-282, 459-486

The direct-engine path bypasses the pipeline planner for maximum
performance (the path the reference CLI uses, helpers.go:77-91); one-shot
helpers run the engine's fully-static compiled program (engine/oneshot.py).
"""

from __future__ import annotations

import numpy as np

from .api import (Config, QualityPreset, QualitySpec, BufferTooSmallError,
                  new_resampler, ESTIMATE_OUTPUT_MARGIN)
from .engine import EngineCore, plan_engine, oneshot
from .filterdesign import Quality as EngineQuality

# Common sample rates (convenience.go:11-41)
RATE_CD = 44100
RATE_DAT = 48000
RATE_HIRES_88 = 88200
RATE_HIRES_96 = 96000
RATE_HIRES_176 = 176400
RATE_HIRES_192 = 192000
RATE_TELEPHONY = 8000
RATE_VOIP = 16000
RATE_SPEECH = 22050
RATE_VIDEO = 48000


def new_cd_to_dat(quality: QualityPreset = QualityPreset.HIGH):
    """CD (44.1k) -> DAT (48k) pipeline resampler (convenience.go:43-52)."""
    return new_resampler(Config(RATE_CD, RATE_DAT, channels=1,
                                quality=QualitySpec(preset=quality)))


def new_dat_to_cd(quality: QualityPreset = QualityPreset.HIGH):
    return new_resampler(Config(RATE_DAT, RATE_CD, channels=1,
                                quality=QualitySpec(preset=quality)))


def new_cd_to_hires(quality: QualityPreset = QualityPreset.HIGH):
    return new_resampler(Config(RATE_CD, RATE_HIRES_88, channels=1,
                                quality=QualitySpec(preset=quality)))


def new_hires_to_cd(quality: QualityPreset = QualityPreset.HIGH):
    return new_resampler(Config(RATE_HIRES_88, RATE_CD, channels=1,
                                quality=QualitySpec(preset=quality)))


def new_simple(input_rate: float, output_rate: float):
    """Mono pipeline resampler at QualityHigh (convenience.go:84-93)."""
    return new_resampler(Config(input_rate, output_rate, channels=1,
                                quality=QualitySpec(preset=QualityPreset.HIGH)))


def new_stereo(input_rate: float, output_rate: float,
               quality: QualityPreset = QualityPreset.HIGH):
    return new_resampler(Config(input_rate, output_rate, channels=2,
                                quality=QualitySpec(preset=quality)))


def new_multi_channel(input_rate: float, output_rate: float, channels: int,
                      quality: QualityPreset = QualityPreset.HIGH):
    return new_resampler(Config(input_rate, output_rate, channels=channels,
                                quality=QualitySpec(preset=quality)))


def preset_to_engine_quality(preset: QualityPreset) -> EngineQuality:
    """Preset -> engine quality for the direct path (convenience.go:189-200)."""
    preset = QualityPreset(preset)
    if preset in (QualityPreset.QUICK, QualityPreset.LOW):
        return EngineQuality.LOW
    if preset == QualityPreset.MEDIUM:
        return EngineQuality.MEDIUM
    if preset in (QualityPreset.HIGH, QualityPreset.VERY_HIGH):
        return EngineQuality.HIGH
    return EngineQuality.MEDIUM


class _SimpleBase:
    """Shared direct-engine wrapper (streaming EngineCore, batch=1)."""

    _dtype = np.float64

    def __init__(self, input_rate: float, output_rate: float,
                 quality: QualityPreset, block: int = 2048, batch: int = 1,
                 strict_antialias: bool = False, precision: str = 'auto',
                 hq_interp: bool = False):
        engine_quality = preset_to_engine_quality(quality)
        self.plan = plan_engine(float(input_rate), float(output_rate),
                                engine_quality, strict_antialias, hq_interp)
        self.engine = EngineCore(self.plan, batch=batch, block=block,
                                 dtype=self._dtype, precision=precision)
        self._out_queue = np.zeros(0, dtype=self._dtype)

    def _take(self, fresh: np.ndarray, limit: int | None) -> np.ndarray:
        """Prepend queued output; hold back anything beyond ``limit``.

        The engine drains whole device blocks, so a small call can release
        more output than estimate_output(len(x)); queuing the excess keeps
        the reference's contract that a buffer of estimate_output(n)
        samples is always enough (convenience.go:139-166)."""
        avail = np.concatenate([self._out_queue, fresh])
        if limit is None or len(avail) <= limit:
            self._out_queue = np.zeros(0, dtype=self._dtype)
            return avail
        self._out_queue = avail[limit:]
        return avail[:limit]

    def process(self, x) -> np.ndarray:
        x = np.asarray(x, dtype=self._dtype)
        y = self.engine.process(x[None, :] if x.ndim == 1 else x)[0]
        return self._take(y, None)

    def process_into(self, x, out: np.ndarray) -> int:
        """Resample into a caller buffer; BufferTooSmallError before any
        state advance (convenience.go:139-160).  A buffer of
        estimate_output(len(x)) samples is always sufficient; any output
        the device releases beyond it is queued for the next call."""
        x = np.asarray(x, dtype=self._dtype)
        required = self.estimate_output(len(x))
        if out.shape[-1] < required:
            raise BufferTooSmallError(
                f"output buffer {out.shape[-1]} < required {required}")
        y = self._take(self.engine.process(x[None, :])[0],
                       int(out.shape[-1]))
        out[..., :len(y)] = y
        return len(y)

    def estimate_output(self, n_in: int) -> int:
        """floor(n*ratio) + 64 upper bound (convenience.go:162-166)."""
        return int(n_in * self.plan.ratio) + ESTIMATE_OUTPUT_MARGIN

    def flush(self) -> np.ndarray:
        return self._take(self.engine.flush()[0], None)

    def reset(self) -> None:
        self.engine.reset()
        self._out_queue = np.zeros(0, dtype=self._dtype)

    def get_ratio(self) -> float:
        return self.plan.ratio

    def get_statistics(self) -> dict:
        return self.engine.get_statistics()


class SimpleResampler(_SimpleBase):
    """float64 direct-engine resampler (convenience.go:115-186)."""

    _dtype = np.float64


class SimpleResamplerFloat32(_SimpleBase):
    """float32-native direct-engine resampler (convenience.go:296-395).

    On an accelerator this is the performance path: the whole pipeline
    stays float32.
    """

    _dtype = np.float32

    def process(self, x) -> np.ndarray:
        return super().process(x).astype(np.float32)

    def flush(self) -> np.ndarray:
        return super().flush().astype(np.float32)


def new_engine(input_rate: float, output_rate: float,
               quality: QualityPreset = QualityPreset.HIGH,
               hq_interp: bool = False) -> SimpleResampler:
    """Direct-engine float64 resampler (NewEngine, convenience.go:122-132).

    ``hq_interp`` (beyond reference, non-exact ratios only): corrected
    phase-bank boundary + 8x denser banks — see api.Config.hq_interp.
    """
    return SimpleResampler(input_rate, output_rate, quality,
                           hq_interp=hq_interp)


def new_engine_float32(input_rate: float, output_rate: float,
                       quality: QualityPreset = QualityPreset.HIGH,
                       hq_interp: bool = False) -> SimpleResamplerFloat32:
    """Direct-engine float32 resampler (convenience.go:319-336)."""
    return SimpleResamplerFloat32(input_rate, output_rate, quality,
                                  hq_interp=hq_interp)


def new_variable_rate(input_rate: float, max_output_rate: float, *,
                      output_rate: float | None = None, channels: int = 1,
                      dtype=np.float32, hq: bool = False):
    """Variable-rate resampler (libsoxr SOXR_VR; beyond the Go reference).

    ``max_output_rate`` bounds how high the output rate may ever be set
    (sizes device buffers, soxr-style).  The initial rate defaults to
    ``max_output_rate``; change it at runtime with
    ``set_io_ratio(input_rate / new_output_rate, slew_len)``.
    """
    from .engine.variable import VariableRateResampler

    init_out = output_rate if output_rate is not None else max_output_rate
    return VariableRateResampler(
        max_output_rate / input_rate, input_rate / init_out,
        batch=channels, dtype=dtype, quality='vr-hq' if hq else 'vr')


# --- one-shot helpers -------------------------------------------------------

def _oneshot_1d(x, input_rate, output_rate, quality, dtype) -> np.ndarray:
    plan = plan_engine(float(input_rate), float(output_rate),
                       preset_to_engine_quality(quality))
    x = np.asarray(x, dtype=dtype)
    return np.asarray(oneshot(plan, x[None, :], dtype=dtype))[0]


def resample_mono(x, input_rate: float, output_rate: float,
                  quality: QualityPreset = QualityPreset.HIGH) -> np.ndarray:
    """One-shot mono resample = Process + Flush (convenience.go:202-229).

    Runs the engine's fully static compiled program (one XLA launch).
    """
    return _oneshot_1d(x, input_rate, output_rate, quality, np.float64)


def resample_stereo(left, right, input_rate: float, output_rate: float,
                    quality: QualityPreset = QualityPreset.HIGH):
    """One-shot stereo resample; both channels ride the batch axis in one
    device program (convenience.go:231-257's engine-reuse, without the
    serial Reset dance — channels are independent lanes)."""
    plan = plan_engine(float(input_rate), float(output_rate),
                       preset_to_engine_quality(quality))
    l = np.asarray(left, dtype=np.float64)
    r = np.asarray(right, dtype=np.float64)
    if len(l) != len(r):
        # process independently (reference supports unequal lengths)
        return (resample_mono(l, input_rate, output_rate, quality),
                resample_mono(r, input_rate, output_rate, quality))
    y = np.asarray(oneshot(plan, np.stack([l, r]), dtype=np.float64))
    return y[0], y[1]


def resample_mono_float32(x, input_rate: float, output_rate: float,
                          quality: QualityPreset = QualityPreset.HIGH
                          ) -> np.ndarray:
    """float32 one-shot mono resample (convenience.go:397-414)."""
    return _oneshot_1d(x, input_rate, output_rate, quality, np.float32)


def resample_stereo_float32(left, right, input_rate: float, output_rate: float,
                            quality: QualityPreset = QualityPreset.HIGH):
    """float32 one-shot stereo resample (convenience.go:431-457)."""
    plan = plan_engine(float(input_rate), float(output_rate),
                       preset_to_engine_quality(quality))
    l = np.asarray(left, dtype=np.float32)
    r = np.asarray(right, dtype=np.float32)
    if len(l) != len(r):
        return (resample_mono_float32(l, input_rate, output_rate, quality),
                resample_mono_float32(r, input_rate, output_rate, quality))
    y = np.asarray(oneshot(plan, np.stack([l, r]), dtype=np.float32))
    return y[0], y[1]


# --- interleave helpers (convenience.go:259-282, 459-486) -------------------

def interleave_to_stereo(left, right) -> np.ndarray:
    """[L0, R0, L1, R1, ...] from two mono channels."""
    left = np.asarray(left)
    right = np.asarray(right)
    n = min(len(left), len(right))
    out = np.empty(2 * n, dtype=np.result_type(left, right))
    out[0::2] = left[:n]
    out[1::2] = right[:n]
    return out


def deinterleave_from_stereo(interleaved):
    """Two mono channels from [L0, R0, L1, R1, ...]."""
    x = np.asarray(interleaved)
    n = len(x) // 2
    return x[: 2 * n : 2].copy(), x[1: 2 * n : 2].copy()


# float32 aliases for API parity (the numpy versions are dtype-generic)
interleave_to_stereo_float32 = interleave_to_stereo
deinterleave_from_stereo_float32 = deinterleave_from_stereo
