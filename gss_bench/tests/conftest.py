"""Settings of the benchmark's own tests: the marker of the tests that
need a CUDA card (they skip without one, decided inside the test)."""


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs a CUDA card; skips without one')
