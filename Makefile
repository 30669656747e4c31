# Tests run on the CPU backend (float64, 8 virtual devices for the
# sharding tests, see tests/conftest.py); the GPU path is checked by
# `python chip_smoke.py` on a machine with a card.
TEST_ENV = JAX_PLATFORMS=cpu

.PHONY: test test-full bench smoke
# fast tier: < 5 min on one core, still touches every solver family /
# subsystem (one kept representative each — see tests/conftest.py)
test:
	$(TEST_ENV) python -m pytest tests/ -x -q -m "not slow"

# everything, ~55 min on one core
test-full:
	$(TEST_ENV) python -m pytest tests/ -x -q

bench:
	python bench.py

smoke:
	python chip_smoke.py
