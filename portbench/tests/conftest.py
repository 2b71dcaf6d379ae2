"""Settings of the benchmark's own tests (`python -m pytest portbench/tests -q`)."""

import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where CUDA is absent")
    torch.set_num_threads(min(4, torch.get_num_threads()))
