"""Vectorized torch execution layer for query fragments.

SQL arithmetic (TPC-H decimals) runs in float64/int64: torch has both
without a global switch, so unlike the reference nothing is configured
at import.
"""

from repro_torch.exec.batch import (Block, bucket_capacity, from_numpy,
                                    resolve_device, to_numpy)
from repro_torch.exec.expr import compile_expr, expr_from_dict, expr_to_dict

__all__ = ["Block", "bucket_capacity", "compile_expr", "expr_from_dict",
           "expr_to_dict", "from_numpy", "resolve_device", "to_numpy"]
