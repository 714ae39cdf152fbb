"""One intra-op thread for PyTorch's CPU kernels, for tests that hold two
separate CPU calls to each other bit for bit.

A CPU reduction's result depends on the thread count (it sets how the sum
is split into partial sums), and under a loaded parallel test run MKL and
OpenMP may pick another count for the second call than for the first."""

import contextlib

import torch


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
