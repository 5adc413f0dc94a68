"""One native host library on both sides of the port's parity tests.

The JAX package and the port each build their copy of the native host
library (``libvqgnn_graph.so``: random walks, partitions, k-hop subgraphs)
with ``make`` at first use.  The port builds under a file lock; the JAX
package does not, so under a parallel test run a worker can find the JAX
library half written, fail to load it, and take the numpy fallback for the
rest of its life.  The two backends draw different random walks and
partitions from the same seed, and every host-batch comparison between the
packages then compares different batches.

:func:`steady_native` closes that: every port test file that drives JAX
host code calls it at import, so in every worker, at collection time,
before any test runs.  It builds and loads the JAX library under the port's
build lock, loads it again once a build elsewhere has finished where an
earlier load failed, and asserts that both packages use the same backend.
"""

import fcntl
import os
import time

from vq_gnn_tpu.native import lib as jlib
from vq_gnn_tpu_torch.native import lib as tlib

# a build that is seen half written is waited for this long (the make
# timeout of both loaders)
_WAIT_S = 120.0


def _load_jax_lib() -> bool:
    """Load the JAX package's library, retrying a failed load while a build
    elsewhere may still be writing the file.  True when it is loaded."""
    deadline = time.monotonic() + _WAIT_S
    while True:
        if jlib._lib is None:
            jlib._tried = False  # forget a failed load: try again
            jlib._load()
        if jlib._lib is not None or not os.path.exists(jlib._SO):
            return jlib._lib is not None
        if time.monotonic() > deadline:
            return False
        time.sleep(0.25)


def steady_native() -> bool:
    """Build and load both native libraries, one build at a time across the
    processes that share this checkout, and return whether they are native
    (True) or both numpy (False).  Raises if the two packages disagree."""
    with open(os.path.join(tlib._HERE, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            jax_native = _load_jax_lib()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    port_native = tlib.available()  # the port's loader takes the lock itself
    if jax_native != port_native:
        raise RuntimeError(
            f"native host library: the JAX package's is "
            f"{'loaded' if jax_native else 'not loaded'}, the port's "
            f"{'loaded' if port_native else 'not loaded'}; the two would draw different "
            "random walks and partitions from one seed"
        )
    return port_native


steady_native()


def test_both_packages_use_one_backend():
    native = steady_native()
    assert (jlib._lib is not None) == (tlib._lib is not None) == native
    assert steady_native() == native  # idempotent


def test_a_failed_load_is_retried(monkeypatch):
    """A worker whose first load of the JAX library failed (a half-written
    file) loads it on the next call: the stale failure is forgotten."""
    if not steady_native():  # no toolchain: both packages are on numpy
        assert jlib._lib is None and tlib._lib is None
        return
    monkeypatch.setattr(jlib, "_lib", None)
    monkeypatch.setattr(jlib, "_tried", True)
    assert jlib._load() is None  # the stale state alone never loads again
    assert steady_native()
    assert jlib._lib is not None
