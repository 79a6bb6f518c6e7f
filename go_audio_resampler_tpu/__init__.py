"""go_audio_resampler_tpu: accelerator audio sample-rate conversion.

A from-scratch JAX/XLA reimplementation of the capabilities of
tphakala/go-audio-resampler (a pure-Go libsoxr-style resampler): multi-stage
polyphase-FIR sample-rate conversion with Kaiser-window filter design, five
quality presets, float32/float64 paths, streaming Process/Flush semantics,
batched multi-channel and multi-stream processing, and a quality test suite
validated against captured libsoxr reference data.

Architecture (device-first, not a port):

- filter design runs at trace time on the host (numpy float64) and bakes
  constant coefficient banks into compiled XLA programs;
- the polyphase inner loop is a closed-form fixed-point phase walk feeding
  gather+einsum / banded frames-matmul programs;
- channels and concurrent streams ride a leading batch axis (replacing the
  reference's goroutine-per-channel parallelism);
- streaming state (history tails, fixed-point accumulators) is an explicit
  pytree carried across fixed-size blocks, giving chunking invariance and
  checkpointable streams by construction.
"""

from .api import (
    Config,
    QualityPreset,
    QualitySpec,
    QualityFlags,
    Info,
    Resampler,
    ResamplerError,
    InvalidConfigError,
    BufferTooSmallError,
    NotSupportedError,
    new_resampler,
    get_preset_spec,
    get_info,
    precision_to_engine_quality,
    MAX_CHANNELS,
    ESTIMATE_OUTPUT_MARGIN,
)
from .convenience import (
    RATE_CD, RATE_DAT, RATE_HIRES_88, RATE_HIRES_96, RATE_HIRES_176,
    RATE_HIRES_192, RATE_TELEPHONY, RATE_VOIP, RATE_SPEECH, RATE_VIDEO,
    SimpleResampler,
    SimpleResamplerFloat32,
    new_engine,
    new_engine_float32,
    new_variable_rate,
    new_cd_to_dat,
    new_dat_to_cd,
    new_cd_to_hires,
    new_hires_to_cd,
    new_simple,
    new_stereo,
    new_multi_channel,
    preset_to_engine_quality,
    resample_mono,
    resample_stereo,
    resample_mono_float32,
    resample_stereo_float32,
    interleave_to_stereo,
    deinterleave_from_stereo,
    interleave_to_stereo_float32,
    deinterleave_from_stereo_float32,
)
from .engine import EngineCore, plan_engine, oneshot, VariableRateResampler
from .filterdesign import Quality as EngineQuality
from . import functional
from .functional import resample

__version__ = "0.4.0"

__all__ = [
    "Config", "QualityPreset", "QualitySpec", "QualityFlags", "Info",
    "Resampler", "ResamplerError", "InvalidConfigError",
    "BufferTooSmallError", "NotSupportedError", "new_resampler",
    "get_preset_spec", "get_info", "precision_to_engine_quality",
    "MAX_CHANNELS", "ESTIMATE_OUTPUT_MARGIN",
    "RATE_CD", "RATE_DAT", "RATE_HIRES_88", "RATE_HIRES_96",
    "RATE_HIRES_176", "RATE_HIRES_192", "RATE_TELEPHONY", "RATE_VOIP",
    "RATE_SPEECH", "RATE_VIDEO",
    "SimpleResampler", "SimpleResamplerFloat32", "new_engine",
    "new_engine_float32", "new_variable_rate", "new_cd_to_dat", "new_dat_to_cd",
    "new_cd_to_hires", "new_hires_to_cd", "new_simple", "new_stereo",
    "new_multi_channel", "preset_to_engine_quality", "resample_mono",
    "resample_stereo", "resample_mono_float32", "resample_stereo_float32",
    "interleave_to_stereo", "deinterleave_from_stereo",
    "interleave_to_stereo_float32", "deinterleave_from_stereo_float32",
    "EngineCore", "plan_engine", "oneshot", "EngineQuality",
    "VariableRateResampler", "functional", "resample",
]
