"""The SQL front end: lexer, parser, binder, statistics, cost-based
optimizer and plan rewrites.

Host-only code, kept as the port's own copies of the JAX package's
`matrixone_tpu/sql/` modules of the same names (the port may not import
that package): verbatim apart from the imports, and apart from the
places that reach beyond this slice — user-defined functions and
`load_file()` — which raise NotImplementedError.  `tests/test_torch_sql.py`
holds the copies to the originals through equal `plan.explain` text.
"""

from matrixone_tpu_torch.sql import ast, binder, expr, lexer, parser, plan

__all__ = ["ast", "binder", "expr", "lexer", "parser", "plan"]
