"""Torch's intra-op thread count for the port's CPU tests.

The tier-1 run puts several pytest workers on one machine.  At torch's
default count (one thread a core) each worker's parallel regions wait
on threads that the other workers have taken off the cores, and a test
of many small ops (the loop engine, a round's host work) ran 40x its
time alone.  A port test module imports ``torch_intra_op_threads``, an
autouse module fixture, to run at ``THREADS``: for contention only.  The
results do not depend on the count: the cohort's local SGD runs its
products one client at a time at one thread (ROADMAP C14, fixed;
``tests/test_torch_cohort_cpu.py`` holds a step and the engines at 1, 2
and 4 threads).
"""
import contextlib

import pytest
import torch

THREADS = 2


@contextlib.contextmanager
def intra_op_threads(n: int):
    """Torch's intra-op thread count at ``n`` inside the block."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def torch_intra_op_threads():
    """The module's tests at ``THREADS`` intra-op threads."""
    with intra_op_threads(THREADS):
        yield
