"""Process-wide state that the port's tests which drive JAX engines keep
to themselves.

The JAX package's compile log is process-wide and the reference's own
tests read its ``post_warmup_decode_compiles`` absolutely: a JAX engine
in a port test compiling a key that an earlier one marked warm would
fail them later in the same worker.  A test module imports
``_private_jax_compile_log`` (an autouse module fixture) and its JAX
engines log into a private instance; the shared one is put back after.
"""
from __future__ import annotations

import pytest


@pytest.fixture(scope="module", autouse=True)
def _private_jax_compile_log():
    from paddle_infer_tpu.observability import compilelog as jcompilelog

    saved = jcompilelog._LOG
    jcompilelog._LOG = jcompilelog.CompileLog()
    yield
    jcompilelog._LOG = saved
