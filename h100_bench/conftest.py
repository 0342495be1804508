"""pytest settings of the benchmark's own tests: the `cuda` marker for the
tests that need the card (they skip without one)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped without one")
