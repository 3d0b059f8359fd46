"""Serving configuration checks (port of the validation half of
``paddle_infer_tpu/serving/sharded/``).  Sharded serving itself is not
ported yet (ROADMAP.md slice B)."""
from .mesh import ShardedConfigError, validate_kv_quant_combo

__all__ = ["ShardedConfigError", "validate_kv_quant_combo"]
