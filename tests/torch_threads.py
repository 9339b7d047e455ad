"""Keep a pytest-xdist worker's torch to its share of the host's cores.

Each xdist worker is one process, and torch's intra-op pool takes one
thread per core in each: six workers on eight cores run about 48 threads,
and every small op then waits on an oversubscribed parallel region (a
file of many small products ran some 50 times slower under the other
workers than alone). The port's test files import this module; the first
import in a process sets the count. Outside xdist nothing changes."""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
if WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))
