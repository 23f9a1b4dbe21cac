"""pytest settings of the benchmark's own tests: the `gpu` marker (the
tests that need a CUDA card skip without one)."""


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA card; skips without one")
