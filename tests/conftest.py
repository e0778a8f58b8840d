"""Pytest settings: registers the marker of tests that need a CUDA card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA Hopper card and nvcc; skipped elsewhere with "
        "a reason naming what is missing")
