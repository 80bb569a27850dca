"""Settings of the benchmark's own tests: the `cuda` marker for tests
that need the card (they decide inside the test and skip here)."""
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")
    torch.set_num_threads(2)
