"""Process-wide state that the port's tests which drive JAX engines keep
to themselves.

The JAX package's compile log is process-wide and the reference's own
tests read its ``post_warmup_decode_compiles`` absolutely: a JAX engine
in a port test compiling a key that an earlier one marked warm would
fail them later in the same worker.  A test module imports
``_private_jax_compile_log`` (an autouse module fixture) and its JAX
engines log into a private instance; the shared one is put back after.

The JAX package's native library (``native/libpitnative.so``, the block
pool of every JAX engine) is built in place with ``make`` at first use,
and a failed load is latched for the life of the process.  Under
``pytest -n`` on a tree without the library, every worker reaches that
first use while collecting ``tests/test_native.py`` (its module-level
``skipif(not native.available())``), all at once and without a lock:
one worker loading the library while another's linker writes it gets
"file too short", and every JAX engine in that worker then fails —
including those the port's parity tests compare against.  Importing
this module (every port test module that drives a JAX engine does, so
each worker does while collecting, before any test runs) calls
``ensure_jax_native``, which loads the library under a file lock and
clears such a latched failure once the racing builds have finished.
"""
from __future__ import annotations

import fcntl
import os
import time

import pytest

from paddle_infer_tpu_torch import native

LOCK = os.path.join(native.BUILD_DIR, "jax-native.lock")


def _load_private_copy(jnative):
    """Load a private copy of the finished library: under the shared
    path the process may already hold a half-written image (a load that
    passed ``dlopen`` but missed symbols), which a second ``dlopen`` of
    that path would return again.  The copy is unlinked once mapped."""
    import shutil
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".so", dir=native.BUILD_DIR)
    os.close(fd)
    shared = jnative._LIB_PATH
    try:
        shutil.copyfile(shared, path)
        jnative._LIB_PATH = path
        jnative._load_error = None
        jnative._build_attempted = True          # load only, never make
        return jnative._load()
    finally:
        jnative._LIB_PATH = shared
        os.unlink(path)


def ensure_jax_native(attempts: int = 10, wait_s: float = 1.0) -> bool:
    """Load the JAX package's native library while holding ``LOCK`` (so
    the workers that get here build it one at a time).  A failure
    latched by an earlier, unlocked load is cleared by loading a private
    copy of the library, retried up to ``attempts`` times ``wait_s``
    apart while a build outside the lock finishes.  Returns whether the
    library is loaded; never raises, so a tree that cannot build it
    still collects."""
    from paddle_infer_tpu import native as jnative

    os.makedirs(native.BUILD_DIR, exist_ok=True)
    with open(LOCK, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            if jnative._load() is not None:
                return True
            for _ in range(attempts):
                time.sleep(wait_s)
                if (os.path.exists(jnative._LIB_PATH)
                        and _load_private_copy(jnative) is not None):
                    return True
            return False
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


ensure_jax_native()


@pytest.fixture(scope="module", autouse=True)
def _private_jax_compile_log():
    from paddle_infer_tpu.observability import compilelog as jcompilelog

    saved = jcompilelog._LOG
    jcompilelog._LOG = jcompilelog.CompileLog()
    yield
    jcompilelog._LOG = saved
