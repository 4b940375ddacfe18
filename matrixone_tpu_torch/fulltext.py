"""The full-text tokenizer: the port's copy of `tokenize` from
`matrixone_tpu/fulltext/__init__.py` (the BM25 index itself is not
ported).  `match_against` over a string column uses it."""

from __future__ import annotations

import re
from typing import List

_WORD_RE = re.compile(r"[A-Za-z0-9_]+")
_CJK_RUN_RE = re.compile(r"[\u3040-\u30FF\u3400-\u9FFF]+")


def tokenize(text: str) -> List[str]:
    """Lowercased word tokens; each CONTIGUOUS CJK run is segmented by
    the dictionary-driven monlp segmenter (reference: pkg/monlp jieba
    tokenizer), with character bigrams as the out-of-vocabulary
    fallback so unknown text stays searchable."""
    from matrixone_tpu_torch import monlp
    out: List[str] = []
    if not text:
        return out
    for m in _WORD_RE.finditer(text):
        out.append(m.group(0).lower())
    for m in _CJK_RUN_RE.finditer(text):
        out.extend(monlp.tokenize_cjk_run(m.group(0)))
    return out
