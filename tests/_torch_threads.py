"""One thread per test for the port's CPU tests that train end to end.

The tier-1 run shares the CPU's cores among its pytest workers.  Torch's
intra-op pool and the OpenMP and BLAS pools (scikit-learn's k-means among
them) each start a thread per core and spin at their barriers, so with
several workers those pools stall one another and a test that takes a
second alone can take a minute.  A test file opts in with::

    from tests._torch_threads import one_thread  # noqa: F401
    pytestmark = pytest.mark.usefixtures("one_thread")

Both packages of a comparison run under the same limit.
"""

import pytest
import torch


@pytest.fixture
def one_thread():
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(n)
