"""One CPU thread for the port's tests.

The port's CPU tests run tiny tensors, where torch's default thread pool
(one thread per core) buys nothing.  Under ``pytest -n 6 --dist loadfile``
they share the machine with ``tests/test_case_studies.py``, whose ST and
NPAR1WAY verdicts rest on clock-calibrated region costs, so every port test
file that runs torch takes :func:`one_torch_thread` (autouse once imported
into the file) and every child process a test starts gets
:data:`ONE_THREAD_ENV`.
"""
import pytest
import torch

ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
