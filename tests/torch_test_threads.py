"""One fixture for every ``tests/test_torch_*.py`` module: torch's
intra-op threads capped while the module runs, and put back after it.

``from torch_test_threads import torch_threads  # noqa: F401`` in a test
module registers it there (an imported fixture is the module's own);
it is autouse and module-scoped. The cap is the machine's cores over
the test runner's workers (``PYTEST_XDIST_WORKER_COUNT``), at least 1:
under ``pytest -n 6`` on 8 cores that is 1, where a module's small ops
on every core wait on each other and on five other workers (a
MobileNet trajectory took 60-80 s there and 1-3 s alone; the port's
files took 4379 test-seconds before this cap and 1975 with it). Alone
on 8 cores it is every core: ``test_torch_gpt.py`` took 87.2 s so and
106.8 s on one thread.

A module whose few large ops run faster on every thread sets
``TORCH_THREADS = None`` to keep torch's count (``test_torch_vision_vgg``:
VGG-11's 4 bfloat16 steps take 10.7 s on one thread and 2.9 s on eight).
"""
import os

import pytest
import torch

__all__ = ["torch_threads"]


def _cap():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // workers)


@pytest.fixture(autouse=True, scope="module")
def torch_threads(request):
    n = getattr(request.module, "TORCH_THREADS", _cap())
    old = torch.get_num_threads()
    if n is not None:
        torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)
