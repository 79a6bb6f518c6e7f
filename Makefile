# Build/test/bench entry points (Taskfile.yml counterpart of the reference).

PY ?= python

.PHONY: test test-quick bench bench-all lint native clean quality smoke

test: native
	$(PY) -m pytest tests/ -q

test-quick: native
	$(PY) -m pytest tests/ -q -x -k "not quality"

bench:
	$(PY) bench.py

bench-all:
	$(PY) benchmarks/run_all.py

# Quality floors measured on the default device's float32 output.
quality:
	$(PY) tools/quality_device.py

# The serving path once on the GPU, every phase checked (needs a card).
smoke:
	$(PY) chip_smoke.py

lint:
	$(PY) tools/lintcheck.py go_audio_resampler_tpu tests bench.py chip_smoke.py __graft_entry__.py

native:
	$(MAKE) -s -C go_audio_resampler_tpu/native

clean:
	$(MAKE) -s -C go_audio_resampler_tpu/native clean
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
