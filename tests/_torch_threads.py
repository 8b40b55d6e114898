"""Torch's intra-op threads in the port's test processes.

pytest-xdist runs each worker as a process of its own, and torch sizes
its intra-op pool (an OpenMP team for every thread that runs torch ops)
to every core in each of them. With six workers on eight cores the teams
of all workers, beside XLA's own pools, far outnumber the cores, and the
port's test files then run 8–18 times longer under ``-n 6`` than alone.
Each of the port's test modules calls ``cap()`` when it is imported,
which every worker does while collecting.
"""
import os

import torch


def cap() -> None:
    """Under pytest-xdist (``PYTEST_XDIST_WORKER_COUNT`` workers), give a
    worker's torch ``cores // workers`` intra-op threads, at least one; a
    run in one process keeps torch's default."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
