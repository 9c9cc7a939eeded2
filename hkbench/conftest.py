"""pytest settings of the benchmark's own tests (python3 -m pytest hkbench)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device; skips without one (decided inside the test)")
