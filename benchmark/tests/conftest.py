"""CPU tests of the benchmark: ``pytest benchmark/tests`` from the repo root."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]
# The manifest rules live outside the test files: show their values on a failure.
pytest.register_assert_rewrite("manifest_rules")


@pytest.fixture(autouse=True)
def one_thread():
    """MKL's batched LU hangs on element blocks of a few hundred rows at
    more than one thread on the CPU."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_card():
    """Skip where a CUDA device is present: the test checks the refusal."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines without one")
