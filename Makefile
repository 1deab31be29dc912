# Convenience targets (CI parity with the reference's .gitlab-ci.yml
# unittests/builddocs jobs).

.PHONY: test bench chip-smoke baseline suite entrycheck lint

test:
	python -m pytest tests/ -q

bench:
	python bench.py

chip-smoke:
	python chip_smoke.py

suite:
	python benchmarks/suite.py

baseline:
	python benchmarks/reference_baseline.py

entrycheck:
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	python -c "import jax; \
	import numpy as np, __graft_entry__ as g; f,a=g.entry(); \
	print(np.asarray(jax.jit(f)(*a)).shape); g.dryrun_multichip(8); \
	print('dryrun OK')"

lint:
	python -m pyflakes nsol_tpu tests bench.py chip_smoke.py __graft_entry__.py 2>/dev/null \
	|| python -m py_compile $$(git ls-files '*.py')
