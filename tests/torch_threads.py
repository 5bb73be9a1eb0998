"""Each xdist worker's torch thread pool, sized to its share of the cores.

Every xdist worker is a process of its own, and torch sizes its OpenMP
pool to all of the machine's cores in each of them. While the other
workers hold those cores, every parallel region waits for threads that
are not running: a small CPU training loop that takes seconds alone
takes many minutes beside five busy workers, whichever test file it is
in. The port's test modules import this module, so every worker sets its
pool to its share, cores // workers threads (at least one), while it
collects, before it runs any test, and keeps it for whatever tests it
then draws. A module's own fixture may still raise it around that
module's tests. Outside xdist nothing changes.
"""

import os

import torch


def worker_share():
    """Threads for this worker: the cores it may run on over the workers."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // workers)


if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(min(torch.get_num_threads(), worker_share()))
