"""User-defined functions (the port of `matrixone_tpu/udf`; reference
analogue: pkg/udf + pkg/udf/pythonservice — the CREATE FUNCTION
catalog, restricted-dialect bodies, vectorized execution).

Layout:
  catalog.py  — the system_udf table + the registry derived from it
  sandbox.py  — the restricted dialect's validation + frozen exec
  jnp.py      — the torch-backed `jnp` namespace bodies see
  executor.py — the jit / row / aggregate tiers over one compile cache
"""

from matrixone_tpu_torch.udf.catalog import (UDF_TABLE, UdfMeta,
                                             ensure_table, is_udf_table,
                                             lookup, nondet_names,
                                             registry_for, sync_serving,
                                             validate_meta)
from matrixone_tpu_torch.udf.executor import (COMPILE_CACHE,
                                              eval_udf_aggregate,
                                              eval_udf_call, expected_tier,
                                              stats)
from matrixone_tpu_torch.udf.sandbox import UdfError, compile_body

__all__ = ["UDF_TABLE", "UdfMeta", "UdfError", "COMPILE_CACHE",
           "compile_body", "ensure_table", "eval_udf_aggregate",
           "eval_udf_call", "expected_tier", "is_udf_table", "lookup",
           "nondet_names", "registry_for", "stats", "sync_serving",
           "validate_meta"]
