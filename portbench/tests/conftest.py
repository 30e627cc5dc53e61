"""The benchmark's own tests: the card marker, and a small copy of the
benchmark for each test that runs a cell."""

import pytest

from benchutil import small_copy


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def bench_copy(tmp_path):
    return small_copy(str(tmp_path / "checkout"))
