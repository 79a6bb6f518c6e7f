"""Mutation check: verify the suite catches injected engine bugs.

Applies each mutation to a copy-restored source file, runs a targeted
pytest subset, and reports CAUGHT (tests failed) or SURVIVED (tests
passed).  A SURVIVED non-equivalent mutant means the suite lacks
discriminating power on that path; the run exits 1.

This is the framework analog of the reference's test-depth guarantee
(its 38 engine test files cross-check every topology's values); here the
same assurance is spot-checked by mutating the length model
(engine/counts.py) and the streaming phase walk (engine/stages.py).

Usage:  python tools/mutation_check.py [filter]   (from the repo root;
        the optional filter substring selects by file path or note)
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

# (file, old, new, pytest targets, note)
MUTATIONS = [
    (
        "go_audio_resampler_tpu/engine/counts.py",
        "num_out = (limit - self.at + self.step - 1) // self.step",
        "num_out = (limit - self.at) // self.step",
        ["tests/test_engine_core.py"],
        "poly count model: floor instead of ceil",
    ),
    # NOTE an over-consume mutant (consumed += 1 in PolyphaseSim.process)
    # is *equivalent* under the product's call pattern: canonical() feeds
    # the sim three large blocks, the min(consumed, hist) clamp never
    # binds, and at/hist shift together — verified by exhaustive n-sweep
    # over every two_stage config in the test matrix.  Use the window
    # count instead, which canonical() totals depend on directly.
    (
        "go_audio_resampler_tpu/engine/counts.py",
        "num_in = self.hist - self.taps + 1",
        "num_in = self.hist - self.taps + 2",
        ["tests/test_engine_core.py"],
        "poly count model: valid-window count off by one",
    ),
    (
        "go_audio_resampler_tpu/engine/stages.py",
        "x = frac.astype(hist.dtype) * (1.0 / 65536.0)",
        "x = frac.astype(hist.dtype) * (1.0 / 65600.0)",
        ["tests/test_engine_core.py"],
        "streaming walk: wrong fraction scale (needs the non-exact-"
        "rational topology rows to be caught)",
    ),
    (
        "go_audio_resampler_tpu/engine/oneshot.py",
        "at = plan.at0 + np.arange(count, dtype=np.int64) * plan.step",
        "at = plan.at0 + 1 + np.arange(count, dtype=np.int64) * plan.step",
        ["tests/test_independent_oracle.py", "tests/test_engine_core.py"],
        "oneshot host walk: phase origin off by one frac unit",
    ),
    # --- lowering tier: the gather + einsum frames paths must be caught
    # by their dense-reference tests ---
    (
        "go_audio_resampler_tpu/engine/streaming.py",
        "    starts = lax.iota(jnp.int32, n_frames) * I32(ipx)\n"
        "    frames = stages.gather_windows(data, starts, wx)",
        "    starts = lax.iota(jnp.int32, n_frames) * I32(ipx) + 1\n"
        "    frames = stages.gather_windows(data, starts, wx)",
        ["tests/test_banded_frames.py"],
        "serving step: frame window start off by one",
    ),
    (
        "go_audio_resampler_tpu/engine/tmajor.py",
        "    idx = starts[:, None] + lax.iota(I32, wx)[None, :]",
        "    idx = starts[:, None] + lax.iota(I32, wx)[None, :] + 1",
        ["tests/test_tmajor.py"],
        "time-major step: row window start off by one",
    ),
    (
        "go_audio_resampler_tpu/engine/oneshot.py",
        "    rs = np.zeros((kf * p, ws), dtype=r.dtype)\n"
        "    for f in range(kf):\n"
        "        rs[f * p:(f + 1) * p, f * ipx:f * ipx + w] = r",
        "    rs = np.zeros((kf * p, ws), dtype=r.dtype)\n"
        "    for f in range(kf):\n"
        "        rs[f * p:(f + 1) * p, f * (ipx - 1):f * (ipx - 1) + w] = r",
        ["tests/test_pipeline_fused.py", "tests/test_engine_core.py"],
        "superframe block-Toeplitz: shifted diagonal (banded off-by-one)",
    ),
    (
        "go_audio_resampler_tpu/engine/stages.py",
        "    shifted = iw - rel[..., None]",
        "    shifted = iw - rel[..., None] - 1",
        ["tests/test_engine_core.py"],
        "banded streaming emit: coefficient placement off by one",
    ),
    (
        "go_audio_resampler_tpu/ops/convolve.py",
        "        return jnp.zeros((w, p * f), x.dtype).at[\n"
        "            jnp.asarray(ii * stride + tau),",
        "        return jnp.zeros((w, p * f), x.dtype).at[\n"
        "            jnp.asarray(ii * stride + tau + 1) % w,",
        ["tests/test_metrics.py"],
        "banded conv matrix: tap row off by one",
    ),
    # --- fusion tier (VERDICT r3 #7: the compose/head algebra in
    # pipeline/fused.py had no mutation coverage; the chain-parity tests
    # must catch a silent off-by-one in the composite frame geometry) ---
    (
        "go_audio_resampler_tpu/pipeline/fused.py",
        "    lam_c = max(0, -pos_min)",
        "    lam_c = max(0, -pos_min - 1)",
        ["tests/test_pipeline_fused.py"],
        "compose: composite left context (lam_c) short by one",
    ),
    (
        "go_audio_resampler_tpu/pipeline/fused.py",
        "        n_head = B.P * _ceil_div(A.n_head + B.lam, B.I)",
        "        n_head = B.P * ((A.n_head + B.lam) // B.I)",
        ["tests/test_pipeline_fused.py"],
        "compose: aperiodic head reach floored instead of ceiled "
        "(last partial head period falls back to the periodic rows)",
    ),
    (
        "go_audio_resampler_tpu/pipeline/fused.py",
        "            mA, rA = divmod(j, A.P)      # floored for j < 0",
        "            mA = math.trunc(j / A.P)     # floored for j < 0\n"
        "            rA = j - mA * A.P",
        ["tests/test_pipeline_fused.py"],
        "compose: truncated instead of floored division for the "
        "left-context taps (j < 0 of a lam > 0 downstream stage)",
    ),
]


def run(mut) -> bool:
    """Apply one mutation, run its tests, restore.  True = caught."""
    path, old, new, targets, note = mut
    src = REPO / path
    text = src.read_text()
    assert old in text, f"mutation site vanished: {path}: {old!r}"
    backup = src.with_suffix(".mutbak")
    shutil.copy(src, backup)
    try:
        src.write_text(text.replace(old, new, 1))
        res = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-x", *targets],
            cwd=REPO, capture_output=True, text=True, timeout=1800)
        caught = res.returncode != 0
        print(f"{'CAUGHT  ' if caught else 'SURVIVED'}  {note}")
        return caught
    finally:
        shutil.move(backup, src)


def _restore_stragglers() -> None:
    """Put back any .mutbak left by a killed run (SIGTERM skips finally)."""
    for bak in REPO.glob("go_audio_resampler_tpu/**/*.mutbak"):
        shutil.move(bak, bak.with_suffix(".py"))
        print(f"restored straggler {bak.with_suffix('.py')}", file=sys.stderr)


def main() -> int:
    import signal

    # A SIGTERM mid-run (driver timeout, task stop) bypasses the finally
    # and would leave a LIVE MUTANT in the tree; convert it to an
    # exception so run()'s restore executes, and sweep stragglers from
    # any previous kill before starting.
    signal.signal(signal.SIGTERM,
                  lambda *a: (_ for _ in ()).throw(KeyboardInterrupt()))
    _restore_stragglers()
    only = sys.argv[1] if len(sys.argv) > 1 else None
    ok = True
    for mut in MUTATIONS:
        if only and only not in mut[0] and only not in mut[4]:
            continue
        ok &= run(mut)
    print("mutation check:", "all caught" if ok else "SURVIVORS — add tests")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
