"""Feature-matrix checks of a serving configuration.

Port of ``ShardedConfigError`` and ``validate_kv_quant_combo`` from
``paddle_infer_tpu/serving/sharded/mesh.py``; ``ServingMesh`` waits for
sharded serving.
"""
from __future__ import annotations

from typing import Optional


class ShardedConfigError(ValueError):
    """A feature combination that cannot serve correctly.  Raised at
    configuration time with an actionable message — never from inside
    the step loop."""


def validate_kv_quant_combo(kv_dtype: Optional[str], *,
                            speculate: bool = False,
                            enable_prefix_cache: bool = False,
                            spec_accept_threshold: Optional[float] = None):
    """The KV-cache-quantization feature matrix, one rule per row.

    * ``kv_dtype=None`` — fp pool, everything allowed (trivially).
    * ``"int8"`` + prefix cache — ALLOWED: pages quantize at write time
      under the slot-0 scale protocol, so a warm (suffix-only) prefill
      reads exactly the bytes a cold prefill wrote and the warm/cold
      stream identity holds *within the quantized domain*.
    * ``"int8"`` + speculation — ALLOWED: the verify lane's target
      logits are computed in the same quantized domain the decode lane
      would have used, so greedy acceptance stays self-consistent and
      the emitted stream equals quantized-domain target-only decoding.
    * ``"int4"`` + speculation — REJECTED unless an explicit
      ``spec_accept_threshold`` is set: 4-bit dequant error is large
      enough to flip near-tie argmax comparisons in the verify lane.
    """
    if kv_dtype not in (None, "int8", "int4"):
        raise ShardedConfigError(
            f"unsupported kv_dtype={kv_dtype!r}; expected 'int8' or "
            "'int4' (or None for the fp KV pool)")
    if spec_accept_threshold is not None:
        t = float(spec_accept_threshold)
        if not 0.0 < t < 1.0:
            raise ShardedConfigError(
                f"spec_accept_threshold={spec_accept_threshold!r} out "
                "of range: expected a margin in (0, 1)")
    if kv_dtype == "int4" and speculate and spec_accept_threshold is None:
        raise ShardedConfigError(
            "kv_dtype='int4' is incompatible with speculative decoding "
            "unless spec_accept_threshold is set: 4-bit KV dequant "
            "error can flip near-tie verify-lane acceptance "
            "comparisons — set an explicit acceptance margin (e.g. "
            "spec_accept_threshold=0.1) or serve with kv_dtype='int8'")
