"""Fixtures of the benchmark's CPU tests."""

import pytest

from hmmbench.tests.helpers import make_tiny


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: tests needing a CUDA device")


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny(tmp_path / "checkout")
