"""Set-up of every test process of the repo, loaded by pytest before the
conftest files under the test folders.

Each process sizes its CPU thread pools, and those of the processes its
tests start, to its share of the cores: the cores it may run on divided
among pytest-xdist's workers. Each of ``-n N`` workers defaulting to every
core oversubscribes the machine, and small torch ops then wait on threads
that are not scheduled.

Where the run uses JAX, its processes share one JAX compilation cache, new
for the run and removed at its end: the JAX package's tests compile many of
the same programs. The port's own processes import no JAX and skip this.
"""

import os
import shutil
import sys
import tempfile
import uuid


def pytest_configure(config):
    # The xdist controller runs no tests, but its environment is its
    # workers': it counts the workers it will start (``-n auto`` is a
    # number by now).
    workers = (int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", 0))
               or config.getoption("numprocesses", None) or 1)
    share = max(1, len(os.sched_getaffinity(0)) // workers)
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(name, str(share))
    import torch

    torch.set_num_threads(share)
    torch.set_num_interop_threads(share)

    jax = sys.modules.get("jax")
    if jax is None:
        return
    # The controller, or a run without xdist, fixes the run's id, which
    # xdist hands to its workers.
    if "PYTEST_XDIST_TESTRUNUID" not in os.environ:
        config.option.testrunuid = (config.getoption("testrunuid", None)
                                    or uuid.uuid4().hex)
    jax.config.update("jax_compilation_cache_dir", _jax_cache_dir(config))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)


def pytest_unconfigure(config):
    if ("jax" in sys.modules
            and "PYTEST_XDIST_WORKER" not in os.environ):
        shutil.rmtree(_jax_cache_dir(config), ignore_errors=True)


def _jax_cache_dir(config):
    uid = (os.environ.get("PYTEST_XDIST_TESTRUNUID")
           or config.option.testrunuid)
    return os.path.join(tempfile.gettempdir(), f"molkgnn-jax-cache-{uid}")
