"""Serial numpy oracle: reference-semantics resampler for test comparison.

A deliberately simple float64 implementation of the reference engine's
streaming semantics (engine/resampler.go, dft_stage.go, polyphase_stage.go)
driven by the same filter plans as the device engine.  Used only as a test
anchor; O(n*taps) per sample, no vectorization tricks.
"""

from __future__ import annotations

import numpy as np

from go_audio_resampler_tpu.engine.plan import EnginePlan
from go_audio_resampler_tpu.engine.counts import CubicSim
from go_audio_resampler_tpu.filterdesign.params import PHASE_FRAC_BITS

_FRAC = 1 << PHASE_FRAC_BITS
_MASK = _FRAC - 1


class OracleDFTUp:
    """dft_stage.go:156-207: polyphase FIR integer upsampling."""

    def __init__(self, coeffs: np.ndarray, factor: int):
        self.coeffs = coeffs  # [F, T], tap-reversed
        self.factor = factor
        self.taps = coeffs.shape[1]
        self.hist = np.zeros(0)

    def process(self, x: np.ndarray) -> np.ndarray:
        if self.factor == 1:
            return x  # unity ratio: pass-through (dft_stage.go:57-59)
        if len(x) == 0:
            return np.zeros(0)
        self.hist = np.concatenate([self.hist, x])
        n_proc = len(self.hist) - self.taps + 1
        if n_proc <= 0:
            return np.zeros(0)
        out = np.zeros(n_proc * self.factor)
        for i in range(n_proc):
            win = self.hist[i:i + self.taps]
            for p in range(self.factor):
                out[i * self.factor + p] = win @ self.coeffs[p]
        self.hist = self.hist[n_proc:]
        return out

    def flush(self) -> np.ndarray:
        if self.factor == 1 or len(self.hist) == 0:
            return np.zeros(0)
        return self.process(np.zeros(self.taps))


class OracleDecim:
    """dft_stage.go:488-553: FIR + integer decimation."""

    def __init__(self, coeffs: np.ndarray, factor: int):
        self.coeffs = coeffs  # [T], tap-reversed
        self.factor = factor
        self.taps = len(coeffs)
        self.hist = np.zeros(0)
        self.phase = 0

    def process(self, x: np.ndarray) -> np.ndarray:
        if len(x) == 0:
            return np.zeros(0)
        self.hist = np.concatenate([self.hist, x])
        filterable = len(self.hist) - self.taps + 1
        if filterable <= 0:
            return np.zeros(0)
        outs = []
        pos = self.phase
        while pos < filterable:
            outs.append(self.hist[pos:pos + self.taps] @ self.coeffs)
            pos += self.factor
        self.phase = ((self.phase - filterable) % self.factor
                      + self.factor) % self.factor
        self.hist = self.hist[filterable:]
        return np.array(outs) if outs else np.zeros(0)

    def flush(self) -> np.ndarray:
        if len(self.hist) == 0:
            return np.zeros(0)
        return self.process(np.zeros(self.taps))


class OraclePoly:
    """polyphase_stage.go:186-311: fixed-point walk with cubic interp."""

    def __init__(self, banks, num_phases: int, taps: int, step: int,
                 at0: int = 0):
        self.A, self.B, self.C, self.D = banks
        self.L = num_phases
        self.taps = taps
        self.step = step
        self.at = at0
        self.hist = np.zeros(0)

    def process(self, x: np.ndarray) -> np.ndarray:
        if len(x) == 0:
            return np.zeros(0)
        self.hist = np.concatenate([self.hist, x])
        num_in = len(self.hist) - self.taps + 1
        if num_in <= 0:
            return np.zeros(0)
        limit = num_in * self.L * _FRAC
        outs = []
        at = self.at
        while at < limit:
            hi = at >> PHASE_FRAC_BITS
            div, phase = divmod(hi, self.L)
            frac = at & _MASK
            xk = frac / _FRAC
            if div + self.taps > len(self.hist):
                break
            k = (self.A[phase] + xk * (self.B[phase]
                 + xk * (self.C[phase] + xk * self.D[phase])))
            outs.append(self.hist[div:div + self.taps] @ k)
            at += self.step
        consumed = min((at >> PHASE_FRAC_BITS) // self.L, len(self.hist))
        self.hist = self.hist[consumed:]
        self.at = at - consumed * self.L * _FRAC
        return np.array(outs) if outs else np.zeros(0)

    def flush(self) -> np.ndarray:
        if len(self.hist) == 0:
            return np.zeros(0)
        return self.process(np.zeros(self.taps))


class OracleCubic:
    """cubic.go:33-90 with the framework's exact 32-bit fixed-point walk."""

    def __init__(self, step: int):
        self.step = step
        self.k = 0
        self.fed = 0
        self.hist = np.zeros(0)

    def process(self, x: np.ndarray) -> np.ndarray:
        if len(x) == 0:
            return np.zeros(0)
        self.hist = np.concatenate([self.hist, x])
        self.fed += len(x)
        outs = []
        while ((self.k * self.step) >> CubicSim.FRAC_BITS) < self.fed:
            at = self.k * self.step
            i = at >> CubicSim.FRAC_BITS
            xk = (at & ((1 << CubicSim.FRAC_BITS) - 1)) / (1 << CubicSim.FRAC_BITS)
            w = np.zeros(4)
            for t in range(4):
                idx = i - 3 + t
                if 0 <= idx < len(self.hist):
                    w[t] = self.hist[idx]
            sm1, s0, s1, s2 = w
            b = 0.5 * (s1 + sm1) - s0
            a = (1.0 / 6.0) * (s2 - s1 + sm1 - s0 - 4.0 * b)
            c = s1 - s0 - a - b
            outs.append(((a * xk + b) * xk + c) * xk + s0)
            self.k += 1
        return np.array(outs) if outs else np.zeros(0)

    def flush(self) -> np.ndarray:
        return np.zeros(0)


def oracle_oneshot(plan: EnginePlan, x: np.ndarray) -> np.ndarray:
    """Process + Flush through the oracle, following resampler.go:275-322."""
    x = np.asarray(x, dtype=np.float64)
    if plan.kind == 'cubic':
        st = OracleCubic(plan.cubic_step)
        return np.concatenate([st.process(x), st.flush()])
    if plan.kind == 'dft_up':
        st = OracleDFTUp(plan.pre_coeffs, plan.factor)
        return np.concatenate([st.process(x), st.flush()])
    if plan.kind == 'decimate':
        st = OracleDecim(plan.decim_coeffs, plan.factor)
        return np.concatenate([st.process(x), st.flush()])
    count = None
    if plan.aa_taps:
        # strict-antialias prefilter: delay-compensated lowpass whose tail
        # extends naturally into the flush padding (it is part of the
        # composed periodic operator on the engine side).  The canonical
        # count stays that of the RAW input; the serial chain sees the
        # longer filtered stream, so its surplus tail outputs are trimmed.
        # Non-aa plans stay untrimmed: their count must emerge from the
        # serial walk itself (the LengthModel-vs-oracle mutation tier
        # depends on that independence).
        count = plan.lengths.canonical(len(x))
        d = (plan.aa_taps - 1) // 2
        x = np.convolve(x, plan.aa_coeffs, mode='full')[d:]
    pre = OracleDFTUp(plan.pre_coeffs, plan.factor)
    poly = OraclePoly((plan.bank_a, plan.bank_b, plan.bank_c, plan.bank_d),
                      plan.num_phases, plan.poly_taps, plan.step)
    out = [poly.process(pre.process(x))]
    out.append(poly.process(pre.flush()))
    out.append(poly.flush())
    return np.concatenate(out)[:count]
