"""Loads both native host libraries once per test process, one process
at a time.

The JAX package builds its library on first use straight onto its final
path and tries once per process (`consent_tpu/native/__init__.py`:
`get_lib`), so under pytest-xdist a worker whose first call meets the
file half-written by another worker's `g++ -o` keeps no library, and
every native case it runs skips.  Every worker imports every test file
before it runs any test, so this module loads both libraries at import
time, under an exclusive lock on a file in `build/`: the first worker to
get the lock builds, the others load the finished file.  A worker whose
earlier first call (an import-time check in another test module) met a
half-written file tries again here once the writer is done.
"""

import fcntl
import os
import time

from consent_tpu import native as jax_native
from consent_tpu_torch import native as torch_native
from consent_tpu_torch.utils.build import BUILD_DIR

LOCK_PATH = os.path.join(BUILD_DIR, "native-prebuild.lock")
# a concurrent first build (g++ of host.cpp) takes seconds; give the
# writer that long to finish before this process gives up
RETRY_S = 60.0


def _jax_lib():
    lib = jax_native.get_lib()
    deadline = time.monotonic() + RETRY_S
    while lib is None and time.monotonic() < deadline:
        time.sleep(0.5)
        # get_lib tries once per process: clear its record of the
        # failed attempt and load (or build) again
        jax_native._tried = False
        lib = jax_native.get_lib()
    return lib


def _load_both():
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(LOCK_PATH, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            return _jax_lib(), torch_native.get_lib()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


JAX_LIB, TORCH_LIB = _load_both()


def test_both_native_libraries_are_loaded():
    assert JAX_LIB is not None
    assert jax_native.get_lib() is JAX_LIB
    assert TORCH_LIB is not None
    assert torch_native.get_lib() is TORCH_LIB
