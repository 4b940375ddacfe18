"""Full-text search on the port against the JAX package, on the CPU.

`matrixone_tpu_torch.fulltext` (BM25 postings as tensors, scored by a
per-term scatter-add) is held to `matrixone_tpu.fulltext` on the same
texts: the index's arrays element for element (the vocabulary's ids
included, CJK text too), the scores within rtol 1e-6 / atol 1e-7, and
the search's positions exactly, ties included (duplicate documents
score alike).  Then the scenarios of tests/test_fulltext.py run through
both sessions (`torch_compare.assert_same`): CREATE INDEX ... USING
fulltext, the FulltextTopK rewrite, OFFSET and the zero-score fill,
the lazy rebuild after DML, multi-column indexes, the empty table and
the no-index fallback.
"""

import numpy as np
import pytest
import torch

from matrixone_tpu import fulltext as JFT
from matrixone_tpu.frontend import Session as JSession
from matrixone_tpu_torch import convert
from matrixone_tpu_torch import fulltext as TFT
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.sql import plan as TP
from matrixone_tpu_torch.sql.parser import parse_one as t_parse
from matrixone_tpu_torch.vectorindex.cache import index_nbytes
from torch_compare import assert_same, reference_env  # noqa: F401

RTOL, ATOL = 1e-6, 1e-7
ARRAYS = ("doc_idx", "tf", "term_offsets", "idf", "doc_norm")


def _np(v) -> np.ndarray:
    """A port index field as numpy (the offsets are already host)."""
    return v.numpy() if isinstance(v, torch.Tensor) else v


CJK_WORDS = ["数据库", "系统", "中国", "北京", "魑魅魍魉", "カタカナ",
             "ひらがな", "中A国"]


def _corpus(kind: str, seed: int = 5):
    rng = np.random.default_rng(seed)
    if kind == "cjk":
        words = CJK_WORDS + ["db", "tpu", "Index"]
    else:
        words = [f"w{i}" for i in range(60)] + ["Quick", "fox", "dog_2"]
    # Zipf-like term draws, empty and NULL documents, duplicates
    p = 1.0 / np.arange(1, len(words) + 1) ** 1.1
    p /= p.sum()
    sep = "" if kind == "cjk" else " "
    texts = [sep.join(rng.choice(words, rng.integers(0, 14), p=p))
             for _ in range(240)]
    texts[7] = None
    texts[8] = ""
    texts += texts[10:30]                  # duplicate documents: ties
    return texts


def _queries(kind: str):
    if kind == "cjk":
        return ["数据库", "中国 北京", "魑魅", "db tpu", "不在", ""]
    return ["w1", "w2 w3", "quick FOX", "w0 w0 w5", "zebra", "w59 zebra",
            ""]


@pytest.mark.parametrize("kind", ["words", "cjk"])
def test_tokenize_equals_reference(kind):
    for t in _corpus(kind)[:60] + ["Hello, World_2!", "中A国", "魑魅魍魉"]:
        assert TFT.tokenize(t or "") == JFT.tokenize(t or "")


@pytest.mark.parametrize("kind", ["words", "cjk"])
def test_build_arrays_equal_reference(kind):
    texts = _corpus(kind)
    want = JFT.build(texts)
    got = TFT.build(texts, device="cpu")
    for f in ARRAYS:
        w = np.asarray(getattr(want, f))
        g = _np(getattr(got, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert list(got.vocab.items()) == list(want.vocab.items())
    assert (got.n_docs, got.max_postings, got.k1, got.b) == \
        (want.n_docs, want.max_postings, want.k1, want.b)
    assert isinstance(got.term_offsets, np.ndarray)    # host, no sync


@pytest.mark.parametrize("texts", [[], [None], ["", None, ""], ["one"]],
                         ids=["none", "null", "empty", "one"])
def test_build_edges_equal_reference(texts):
    want = JFT.build(texts)
    got = TFT.build(texts, device="cpu")
    for f in ARRAYS:
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)))
    assert (got.n_docs, got.max_postings) == (want.n_docs, want.max_postings)
    if not want.vocab:
        # the reference cannot score an empty vocabulary (it indexes an
        # empty idf); the port scores every document 0
        if got.n_docs:
            s_g, _ = TFT.search(got, "one", k=3)
            assert not s_g.any()
        return
    s_w, i_w = JFT.search(want, "one", k=3)
    s_g, i_g = TFT.search(got, "one", k=3)
    np.testing.assert_array_equal(i_g, i_w)
    np.testing.assert_allclose(s_g, s_w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["words", "cjk"])
def test_scores_within_tolerance_of_reference(kind):
    texts = _corpus(kind)
    want = JFT.build(texts)
    got = TFT.build(texts, device="cpu")
    for q in _queries(kind):
        np.testing.assert_allclose(TFT.score_all(got, q),
                                   JFT.score_all(want, q),
                                   rtol=RTOL, atol=ATOL, err_msg=q)
        tids = TFT.term_ids(got, q)
        dense = TFT._score_terms(got, tids)
        assert dense.dtype == torch.float32 and dense.shape == (len(texts),)
        ref = JFT._score_terms(want, np.asarray(tids, np.int32),
                               want.max_postings)
        np.testing.assert_allclose(dense.numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["words", "cjk"])
@pytest.mark.parametrize("k", [1, 5, 23, 400])
def test_search_positions_equal_reference_ties_included(kind, k):
    texts = _corpus(kind)
    want = JFT.build(texts)
    got = TFT.build(texts, device="cpu")
    tied = 0
    for q in _queries(kind):
        s_w, i_w = JFT.search(want, q, k=k)
        s_g, i_g = TFT.search(got, q, k=k)
        np.testing.assert_array_equal(i_g, i_w, err_msg=q)
        np.testing.assert_allclose(s_g, s_w, rtol=RTOL, atol=ATOL)
        tied += int((np.diff(s_w) == 0).sum())
    assert tied > 0 or k == 1, "the corpus must make ties"


def test_top_k_orders_ties_by_position():
    scores = torch.tensor([1.0, 3.0, 3.0, 0.0, 3.0, 1.0, 0.0])
    vals, pos = TFT.top_k(scores, 5)
    assert pos.tolist() == [1, 2, 4, 0, 5]
    assert vals.tolist() == [3.0, 3.0, 3.0, 1.0, 1.0]


def test_index_lives_on_its_device_and_counts_its_bytes():
    ix = TFT.build(_corpus("words"), device="cpu")
    assert ix.device.type == "cpu"
    want = sum(getattr(ix, f).numel() * getattr(ix, f).element_size()
               for f in ARRAYS if f != "term_offsets")
    assert index_nbytes(ix) == want > 0


# ------------------------------------------------ SQL, both sessions

pytestmark = pytest.mark.usefixtures("reference_env")


END_TO_END = [
    "create table docs (id bigint, body text)",
    """insert into docs values (1, 'the quick brown fox'), (2, 'engine tour'),
       (3, 'lazy dog sleeps'), (4, 'quick fox and dog'), (5, null)""",
    "create index ft using fulltext on docs (body)",
    """select id, match(body) against ('quick fox') sc from docs
       order by sc desc limit 2""",
    "delete from docs where id = 4",
    """select id from docs order by match(body) against ('quick fox') desc
       limit 2""",
    "show indexes from docs",
]

NO_INDEX = [
    "create table d2 (id bigint, body text)",
    "insert into d2 values (1, 'alpha beta'), (2, 'gamma'), (3, 'beta beta')",
    "select id from d2 where match(body) against('beta') order by id",
    "select id, match(body) against('beta') from d2 order by id",
]

OFFSET_FILL = [
    "create table d3 (id bigint, body text)",
    "insert into d3 values (1, 'alpha beta'), (2, 'alpha'), (3, 'gamma')",
    "create index f3 using fulltext on d3 (body)",
    """select id, match(body) against ('alpha') sc from d3
       order by sc desc limit 3""",
    """select id from d3 order by match(body) against ('alpha') desc
       limit 1 offset 1""",
    """select id from d3 order by match(body) against ('alpha') desc
       limit 2 offset 2""",
    """select id from d3 order by match(body) against ('zzz') desc
       limit 5""",
]

LAZY_REFRESH = [
    "create table d4 (id bigint, body text)",
    "insert into d4 values (1, 'old news')",
    "create index f4 using fulltext on d4 (body)",
    "insert into d4 values (2, 'fresh fresh fresh news')",
    "select id from d4 order by match(body) against ('fresh') desc limit 1",
    "update d4 set body = 'stale' where id = 2",
    """select id, match(body) against ('fresh news') sc from d4
       order by sc desc limit 2""",
]

MULTI_COLUMN = [
    "create table d5 (id bigint, title varchar(20), body text)",
    """insert into d5 values (1, 'cats', 'about dogs'),
       (2, 'dogs', 'about cats'), (3, null, 'cats cats'), (4, 'x', null)""",
    "create index f5 using fulltext on d5 (title, body)",
    """select id, match(title, body) against ('cats') sc from d5
       order by sc desc limit 3""",
    """select id from d5 order by match(title, body) against ('dogs x')
       desc limit 4""",
]

ALIASED = [
    "create table d6 (id bigint, body text)",
    "insert into d6 values (1, 'hello world'), (2, 'world peace')",
    "create index f6 using fulltext on d6 (body)",
    """select body b, match(body) against ('hello') sc from d6
       order by sc desc limit 1""",
    """select id, body, match(body) against ('world') sc from d6
       order by sc desc limit 2""",
]

EMPTY_TABLE = [
    "create table d7 (id bigint, body text)",
    "create index f7 using fulltext on d7 (body)",
    "select id from d7 order by match(body) against ('x') desc limit 2",
    "insert into d7 values (1, 'x y')",
    "select id from d7 order by match(body) against ('x') desc limit 2",
]

ERRORS = [
    "create table d8 (id bigint, body text, n int)",
    "!create index f8 using fulltext on d8 (n)",
    "!create index f9 using bogus on d8 (body)",
]

CJK = [
    "create table c1 (id bigint, body text)",
    """insert into c1 values (1, '数据库系统'), (2, '中国北京'),
       (3, '数据库 中国'), (4, 'mixed 数据库 text'), (5, '魑魅魍魉')""",
    "create index fc using fulltext on c1 (body)",
    """select id, match(body) against ('数据库') sc from c1
       order by sc desc limit 3""",
    """select id from c1 order by match(body) against ('中国 魑魅') desc
       limit 5""",
]

RANKING_TIES = [
    "create table r1 (id bigint, body text)",
    """insert into r1 values (1, 'red apple'), (2, 'red apple'),
       (3, 'green apple'), (4, 'red apple'), (5, 'apple apple red'),
       (6, 'pear')""",
    "create index fr using fulltext on r1 (body)",
    """select id, match(body) against ('red apple') sc from r1
       order by sc desc limit 4""",
    """select id, match(body) against ('apple') sc from r1
       order by sc desc limit 3 offset 1""",
]

SCRIPTS = {"end_to_end": END_TO_END, "no_index_fallback": NO_INDEX,
           "offset_and_zero_score_fill": OFFSET_FILL,
           "lazy_refresh_after_dml": LAZY_REFRESH,
           "multi_column": MULTI_COLUMN, "aliased_varchar_output": ALIASED,
           "empty_table": EMPTY_TABLE, "errors": ERRORS, "cjk": CJK,
           "ranking_ties": RANKING_TIES}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_fulltext_sql_equals_reference(name):
    assert_same(SCRIPTS[name], rtol=RTOL, atol=ATOL)


def test_rewrite_compiles_fulltext_topk():
    s = TSession(device="cpu")
    for sql in OFFSET_FILL[:3]:
        s.execute(sql)
    sql = ("select id, match(body) against ('alpha') sc from d3 "
           "order by sc desc limit 2")
    plan = s.plan_select(t_parse(sql))

    def kinds(n):
        yield type(n)
        for c in (getattr(n, "child", None),):
            if c is not None:
                yield from kinds(c)
    assert TP.FulltextTopK in set(kinds(plan))
    assert TP.Scan not in set(kinds(plan))
    assert "FulltextTopK" in s.execute("explain " + sql).text


def test_index_carried_across_searches_alike():
    """The JAX session builds the index; `convert` carries its tables
    and its postings into the port, and both answer alike."""
    j = JSession()
    for sql in RANKING_TIES[:2] + ["delete from r1 where id = 2",
                                   RANKING_TIES[2]]:
        j.execute(sql)
    eng = convert.tables_from_numpy(convert.tables_to_numpy(j.catalog))
    convert.indexes_from_numpy(convert.indexes_to_numpy(j.catalog), eng,
                               device="cpu")
    t = TSession(catalog=eng, device="cpu")
    want_ix, got_ix = j.catalog.indexes["fr"], eng.indexes["fr"]
    assert not got_ix.dirty
    for f in ARRAYS:
        np.testing.assert_array_equal(
            _np(getattr(got_ix.index_obj, f)),
            np.asarray(getattr(want_ix.index_obj, f)))
    for sql in RANKING_TIES[3:]:
        w, g = j.execute(sql).rows(), t.execute(sql).rows()
        assert [r[0] for r in g] == [r[0] for r in w]
        np.testing.assert_allclose([r[1] for r in g], [r[1] for r in w],
                                   rtol=RTOL, atol=ATOL)


def test_index_over_object_backed_segments_reads_the_host_tier():
    """After a checkpoint demotes the segments to objects, the build
    reads the texts (and the zero-score fill the row ids) through the
    host tier, and answers as over the segments in memory."""
    steps = RANKING_TIES[:2] + ["insert into r1 values (7, 'apple tart')"]
    want_sql = RANKING_TIES[3:] + [
        "select id from r1 order by match(body) against ('pear') desc "
        "limit 4"]
    mem = TSession(device="cpu")
    obj = TSession(device="cpu")
    for s in (mem, obj):
        for sql in steps:
            s.execute(sql)
    obj.catalog.checkpoint(demote=True)
    assert all(seg.is_lazy for seg in obj.catalog.get_table("r1").segments)
    for s in (mem, obj):
        s.execute(RANKING_TIES[2])
    for sql in want_sql:
        assert obj.execute(sql).rows() == mem.execute(sql).rows()
