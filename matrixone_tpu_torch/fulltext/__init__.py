"""Full-text search: inverted index + BM25 scoring on the device.

The port of `matrixone_tpu/fulltext/__init__.py` (reference analogue:
`pkg/fulltext`, TF-IDF/BM25 ranking, and the `pkg/monlp` tokenizers):

 * tokenize on the host (unicode word splitting, and each CJK run
   segmented by the dictionary-driven monlp segmenter);
 * the inverted index lives on the device as CSR postings,
   term -> (doc_idx[], tf[]) contiguous slices, plus the idf and each
   document's length norm; the term offsets and the vocabulary stay
   on the host, so slicing a term's postings never syncs;
 * a query scores by scatter-adding each term's BM25 contribution into
   a dense [n_docs] f32 vector (`index_add_`; within one term the
   documents are distinct, so the add is deterministic) and takes the
   top k with the JAX package's tie order: equal scores, lower
   position first.

`build` is vectorized with numpy and gives arrays equal, element for
element, to the JAX package's `build` on the same texts.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_WORD_RE = re.compile(r"[A-Za-z0-9_]+")
_CJK_RUN_RE = re.compile(r"[\u3040-\u30FF\u3400-\u9FFF]+")


def tokenize(text: str) -> List[str]:
    """Lowercased word tokens; each CONTIGUOUS CJK run is segmented by
    the dictionary-driven monlp segmenter (reference: pkg/monlp jieba
    tokenizer), with character bigrams as the out-of-vocabulary
    fallback so unknown text stays searchable."""
    from matrixone_tpu_torch import monlp
    if not text:
        return []
    out = [w.lower() for w in _WORD_RE.findall(text)]
    for run in _CJK_RUN_RE.findall(text):
        out.extend(monlp.tokenize_cjk_run(run))
    return out


@dataclasses.dataclass
class FulltextIndex:
    """BM25 index: CSR postings as tensors on one device, plus the host
    offsets and vocabulary a query needs to slice them."""

    doc_idx: torch.Tensor      # [nnz] int32: document position per posting
    tf: torch.Tensor           # [nnz] f32: term frequency per posting
    term_offsets: np.ndarray   # [V+1] int32 CSR into doc_idx/tf (host)
    idf: torch.Tensor          # [V] f32
    doc_norm: torch.Tensor     # [n_docs] f32: k1*(1-b+b*len/avgdl)
    vocab: Dict[str, int] = dataclasses.field(default_factory=dict)
    n_docs: int = 0
    max_postings: int = 0      # longest postings list
    k1: float = 1.2
    b: float = 0.75

    @property
    def device(self) -> torch.device:
        return self.doc_norm.device


def build_arrays(texts: Sequence[Optional[str]], k1: float = 1.2,
                 b: float = 0.75) -> dict:
    """The index's numpy arrays and scalars for `texts` (None = empty
    document): doc_idx, tf, term_offsets, idf, doc_norm, vocab (term ->
    id in order of first appearance), n_docs, max_postings, k1, b."""
    n_docs = len(texts)
    toks = [tokenize(t or "") for t in texts]
    doc_len = np.fromiter((len(t) for t in toks), np.float32, n_docs)
    flat = [w for t in toks for w in t]
    vocab: Dict[str, int] = {w: i for i, w in
                             enumerate(dict.fromkeys(flat))}
    V = len(vocab)
    tids = np.fromiter(map(vocab.__getitem__, flat), np.int64, len(flat))
    docs = np.repeat(np.arange(n_docs, dtype=np.int64),
                     doc_len.astype(np.int64))
    # one (term, doc) key per posting, sorted term-major, docs ascending
    keys, counts = np.unique(tids * max(n_docs, 1) + docs,
                             return_counts=True)
    sizes = np.bincount(keys // max(n_docs, 1), minlength=V)
    offsets = np.zeros(V + 1, np.int32)
    np.cumsum(sizes, out=offsets[1:])
    nnz = len(keys)
    doc_idx = np.zeros(max(nnz, 1), np.int32)
    tf = np.zeros(max(nnz, 1), np.float32)
    doc_idx[:nnz] = keys % max(n_docs, 1)
    tf[:nnz] = counts
    # Robertson/Sparck-Jones idf with +1 flooring (the Lucene/reference form)
    df = sizes.astype(np.float64)
    idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5)).astype(np.float32) \
        if V else np.zeros(0, np.float32)
    avgdl = float(doc_len.mean()) if n_docs else 1.0
    doc_norm = (k1 * (1.0 - b + b * doc_len / max(avgdl, 1e-9))
                ).astype(np.float32)
    return {"doc_idx": doc_idx, "tf": tf, "term_offsets": offsets,
            "idf": idf, "doc_norm": doc_norm, "vocab": vocab,
            "n_docs": n_docs,
            "max_postings": int(sizes.max()) if V else 1,
            "k1": k1, "b": b}


def from_arrays(arrays: dict, device=None) -> FulltextIndex:
    """A FulltextIndex on `device` (CUDA unless named) from the arrays
    and scalars `build_arrays` gives."""
    from matrixone_tpu_torch import resolve_device
    dev = resolve_device(device)

    def put(name, dtype):
        return torch.from_numpy(
            np.require(arrays[name], dtype, ["C", "W"])).to(dev)

    return FulltextIndex(
        doc_idx=put("doc_idx", np.int32), tf=put("tf", np.float32),
        term_offsets=np.array(arrays["term_offsets"], np.int32),
        idf=put("idf", np.float32), doc_norm=put("doc_norm", np.float32),
        vocab=dict(arrays["vocab"]), n_docs=int(arrays["n_docs"]),
        max_postings=int(arrays["max_postings"]),
        k1=float(arrays["k1"]), b=float(arrays["b"]))


def build(texts: Sequence[Optional[str]], k1: float = 1.2,
          b: float = 0.75, device=None) -> FulltextIndex:
    """Tokenize `texts` on the host and place their BM25 index on
    `device` (CUDA unless named)."""
    return from_arrays(build_arrays(texts, k1, b), device)


def term_ids(index: FulltextIndex, query: str) -> np.ndarray:
    """The query's term ids in token order, -1 for a term the index
    lacks ([-1] for an empty query)."""
    return np.asarray([index.vocab.get(t, -1) for t in tokenize(query)]
                      or [-1], np.int64)


def _score_terms(index: FulltextIndex, term_ids: np.ndarray
                 ) -> torch.Tensor:
    """Dense BM25 scores [n_docs] f32 on the index's device for the
    given host term ids (-1 = missing), summed in term order.  A term's
    postings are a slice (the JAX package pads each to
    `max_postings`)."""
    scores = torch.zeros(index.n_docs, dtype=torch.float32,
                         device=index.device)
    for tid in np.asarray(term_ids, np.int64).tolist():
        if tid < 0:
            continue
        start, end = (int(index.term_offsets[tid]),
                      int(index.term_offsets[tid + 1]))
        docs = index.doc_idx[start:end].to(torch.int64)
        tfs = index.tf[start:end]
        norm = index.doc_norm[docs]
        contrib = index.idf[tid] * tfs * (index.k1 + 1.0) / (tfs + norm)
        scores.index_add_(0, docs, contrib)
    return scores


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """The k largest scores, best first, equal scores in position order
    (what `jax.lax.top_k` returns): a stable descending sort."""
    vals, pos = torch.sort(scores, descending=True, stable=True)
    return vals[:k], pos[:k]


def search(index: FulltextIndex, query: str, k: int = 10
           ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (scores [k], doc positions [k]) best-first; score 0 = no match."""
    if index.n_docs == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.int64)
    scores = _score_terms(index, term_ids(index, query))
    k = min(k, index.n_docs) or 1
    top_s, top_i = top_k(scores, k)
    return top_s.cpu().numpy(), top_i.cpu().numpy()


def score_all(index: FulltextIndex, query: str) -> np.ndarray:
    """Dense scores for every document (SQL scalar-function path)."""
    return _score_terms(index, term_ids(index, query)).cpu().numpy()
