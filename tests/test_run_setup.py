"""The set-up of the test processes (``pytest_configure`` in the repo's
root conftest.py): CPU thread pools sized to the process's share of the
cores, and one JAX compilation cache for the run."""

import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import torch


def _share():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", 0)) or 1
    return max(1, len(os.sched_getaffinity(0)) // workers)


def test_torch_pools_hold_the_share_of_the_cores():
    assert torch.get_num_threads() == _share()
    assert torch.get_num_interop_threads() == _share()


def test_a_child_process_inherits_the_share():
    out = subprocess.run(
        [sys.executable, "-c", "import os; print(os.environ['OMP_NUM_THREADS'],"
         " os.environ['MKL_NUM_THREADS'])"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    assert out.split() == [str(_share())] * 2


def test_jax_compiles_into_the_runs_own_cache(request):
    uid = (os.environ.get("PYTEST_XDIST_TESTRUNUID")
           or request.config.option.testrunuid)
    cache = jax.config.jax_compilation_cache_dir
    assert cache == os.path.join(tempfile.gettempdir(),
                                 f"molkgnn-jax-cache-{uid}")
    before = set(os.listdir(cache)) if os.path.isdir(cache) else set()
    jax.jit(lambda x: jnp.cumsum(x) * 3.0 - 1.0)(jnp.arange(7.0))
    assert set(os.listdir(cache)) - before
