"""`llm_embed` on the port against the JAX package, on the CPU, over a
loopback endpoint stub (tests/test_llm.py's `llm_stub`: no network).

The port calls the endpoint once per DISTINCT dictionary entry and
gathers the embeddings on the device by code; a literal argument gives
one row.  Held here: tests/test_llm.py's embed cases through both
sessions, the count of calls, the embeddings equal to the stub's, and
`llm_embed` feeding an IVF-Flat KNN with rows equal to the reference's.
"""

import http.server
import json
import threading
import zlib

import numpy as np
import pytest

from matrixone_tpu_torch import llm as tllm
from matrixone_tpu_torch.frontend import Session as TSession
from torch_compare import assert_same, reference_env  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_env")


def stub_embedding(path: str, text: str, dim: int):
    """What the stub answers.  `/v1` is tests/test_llm.py's stub (ten
    distinct vectors in all); `/rich` draws from the text's CRC, so
    distinct texts get distinct vectors."""
    if path == "/rich":
        rng = np.random.default_rng(zlib.crc32(text.encode()))
        return [float(x) for x in rng.standard_normal(dim).astype(
            np.float32)]
    seed = sum(text.encode()) % 97
    return [((seed + i) % 10) / 10 for i in range(dim)]


@pytest.fixture(scope="module")
def llm_stub():
    calls = {"chat": 0, "embed": 0}

    class H(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):     # noqa: N802
            pass

        def do_POST(self):             # noqa: N802
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n))
            if req["op"] == "chat":
                calls["chat"] += 1
                out = {"text": f"echo: {req['prompt'][:40]}"}
            else:
                calls["embed"] += 1
                out = {"embedding": stub_embedding(
                    self.path, req["text"], int(req["dim"]))}
            body = json.dumps(out).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", calls
    srv.shutdown()
    srv.server_close()


def test_llm_embed_vector_search_equals_reference(llm_stub):
    base, _calls = llm_stub
    got, _port = assert_same([
        f"set llm_endpoint = '{base}/v1'",
        "set llm_embed_dim = 8",
        "select llm_embed('hello')",
        "select l2_distance(llm_embed('hello'), llm_embed('hello'))",
        "select llm_embed('other text') v, llm_embed('hello') w",
    ], rtol=1e-6, atol=1e-7)
    vec = got[2][2][0][0]
    assert len(vec) == 8
    assert list(vec) == pytest.approx(stub_embedding("/v1", "hello", 8))
    assert float(got[3][2][0][0]) < 1e-6


def test_llm_chat_per_distinct_on_the_port(llm_stub):
    base, calls = llm_stub
    s = TSession(device="cpu")
    s.execute(f"set llm_endpoint = '{base}/v1'")
    s.execute("create table p (id bigint primary key, q varchar(32))")
    s.execute("insert into p values (1, 'what is a gpu'), "
              "(2, 'what is a gpu'), (3, 'another question')")
    before = calls["chat"]
    rows = s.execute("select id, llm_chat(q) from p order by id").rows()
    assert [r[1] for r in rows] == ["echo: what is a gpu"] * 2 + \
        ["echo: another question"]
    assert calls["chat"] - before == 2


def test_llm_embed_one_call_per_distinct_text(llm_stub):
    base, calls = llm_stub
    texts = [f"distinct text {i}" for i in range(7)]
    rng = np.random.default_rng(3)
    picks = rng.integers(0, len(texts), 60)
    picks[:len(texts)] = np.arange(len(texts))
    s = TSession(device="cpu")
    s.execute(f"set llm_endpoint = '{base}/rich'")
    s.execute("set llm_embed_dim = 12")
    s.execute("create table e (id bigint, txt varchar(32))")
    s.execute("insert into e values " + ", ".join(
        f"({i}, '{texts[p]}')" for i, p in enumerate(picks)))
    before = calls["embed"]
    rows = s.execute("select id, llm_embed(txt) from e order by id").rows()
    assert calls["embed"] - before == len(texts)
    assert len(rows) == len(picks)
    for (i, vec), p in zip(rows, picks):
        np.testing.assert_array_equal(
            np.asarray(vec, np.float32),
            np.asarray(stub_embedding("/rich", texts[p], 12), np.float32))
    # a NULL text gives a NULL vector; the process cache serves again
    s.execute("insert into e values (99, null)")
    again = s.execute("select id, llm_embed(txt) from e where id = 99 "
                      "or id = 0 order by id").rows()
    assert again[1][1] is None and calls["embed"] - before == len(texts)


def test_llm_embed_without_endpoint_is_loud(monkeypatch):
    monkeypatch.delenv("MO_LLM_ENDPOINT", raising=False)
    s = TSession(device="cpu")
    with pytest.raises(tllm.LLMError, match="llm_endpoint"):
        s.execute("select llm_embed('x')")


def _vec(v) -> str:
    return "[" + ",".join(f"{x:.6f}" for x in v) + "]"


def test_llm_embed_feeds_ivfflat_knn_equal_to_reference(llm_stub):
    base, _calls = llm_stub
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
             "theta", "iota", "kappa", "lambda", "mu"]
    rng = np.random.default_rng(21)
    texts = [" ".join(rng.choice(words, 3)) for _ in range(200)]
    q = _vec(stub_embedding("/rich", "alpha beta gamma", 16))
    assert_same([
        f"set llm_endpoint = '{base}/rich'",
        "set llm_embed_dim = 16",
        "create table src (id bigint, txt varchar(40))",
        "insert into src values " + ", ".join(
            f"({i}, '{t}')" for i, t in enumerate(texts)),
        "create table items (id bigint, txt varchar(40), emb vecf32(16))",
        "insert into items select id, txt, llm_embed(txt) from src",
        "create index iv using ivfflat on items (emb) lists = 4",
        f"select id, txt, l2_distance(emb, '{q}') d from items "
        f"order by d limit 8",
        "select id, l2_distance(emb, llm_embed('beta delta mu')) d "
        "from items order by d limit 5",
    ], rtol=1e-5, atol=1e-4)
