"""Observability of the port: the compile (graph-capture) log."""
from .compilelog import (CompileEvent, CompileLog, get_compile_log,
                         instrument_first_calls, signature_of)

__all__ = ["CompileEvent", "CompileLog", "get_compile_log",
           "instrument_first_calls", "signature_of"]
