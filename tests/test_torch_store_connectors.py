"""The port's Milvus and pgvector connectors (generativeaiexamples_tpu_torch/
retrieval/milvus_store.py, pgvector_store.py) against the JAX package's,
each over the same faithful fakes of ``pymilvus`` and ``psycopg2`` (this
file's own copy of those in tests/test_store_connectors.py, recording every
call). Neither package is installed here, nor is any server reached.

Fed the same chunks and seeded vectors, the two packages make the same
connection, schema, index, insert, search, query and delete calls (the
same expressions and escaping) and the same SQL with the same parameters,
and return equal hits; a missing client package raises the same
``VectorStoreError`` message; the factory reaches each connector with the
configuration's ``url``. Scores within 1e-6 (the fakes' float64 dot
products of the same float32 vectors: in practice bitwise).
"""
import json
import re
import sys
import types

import numpy as np
import pytest

from generativeaiexamples_tpu.retrieval import milvus_store as jmilvus
from generativeaiexamples_tpu.retrieval import pgvector_store as jpg
from generativeaiexamples_tpu.retrieval.errors import VectorStoreError as JVectorStoreError
from generativeaiexamples_tpu.retrieval.store import Chunk as JChunk
from generativeaiexamples_tpu.utils import resilience as jres
from generativeaiexamples_tpu_torch.retrieval import milvus_store as tmilvus
from generativeaiexamples_tpu_torch.retrieval import pgvector_store as tpg
from generativeaiexamples_tpu_torch.retrieval import store as tstore
from generativeaiexamples_tpu_torch.retrieval.errors import VectorStoreError
from generativeaiexamples_tpu_torch.retrieval.store import Chunk
from generativeaiexamples_tpu_torch.utils import resilience as tres

SCORE_TOL = 1e-6
PACKAGES = {
    "jax": (jmilvus.MilvusVectorStore, jpg.PgVectorStore, JChunk),
    "port": (tmilvus.MilvusVectorStore, tpg.PgVectorStore, Chunk),
}


@pytest.fixture(autouse=True)
def _closed_breakers():
    for mod in (jres, tres):
        mod.reset_breakers()
    yield
    for mod in (jres, tres):
        mod.reset_breakers()


# ------------------------------------------------------------------ //
# a fake pymilvus that records every call


class _FakeHit:
    def __init__(self, row, score):
        self._row = row
        self.score = score
        self.entity = self

    def get(self, key):
        return self._row[key]


class _FakeCollection:
    instances = {}
    calls = []

    def __new__(cls, name, schema=None):
        cls.calls.append(("Collection", name, schema))
        if name in cls.instances:
            return cls.instances[name]
        self = super().__new__(cls)
        cls.instances[name] = self
        self.name = name
        self.schema = schema
        self.rows = []
        self.index = None
        self.loaded = False
        return self

    def has_index(self):
        return self.index is not None

    def create_index(self, field, params):
        self.calls.append(("create_index", field, params))
        self.index = (field, params)

    def load(self):
        self.calls.append(("load",))
        self.loaded = True

    def insert(self, columns):
        texts, sources, vectors = columns
        self.calls.append(("insert", list(texts), list(sources), np.asarray(vectors).tolist()))
        for t, s, v in zip(texts, sources, vectors):
            self.rows.append({"text": t, "source": s, "vector": np.asarray(v)})

    def flush(self):
        self.calls.append(("flush",))

    def search(self, data, field, params, limit, output_fields):
        self.calls.append(("search", np.asarray(data).tolist(), field, params, limit,
                           list(output_fields)))
        q = np.asarray(data[0])
        scored = sorted(((float(r["vector"] @ q), i, r) for i, r in enumerate(self.rows)),
                        key=lambda x: (-x[0], x[1]))
        return [[_FakeHit(r, s) for s, _, r in scored[:limit]]]

    def query(self, expr, output_fields):
        self.calls.append(("query", expr, list(output_fields)))
        return [{k: r[k] for k in output_fields} for r in self.rows]

    def delete(self, expr):
        self.calls.append(("delete", expr))
        assert expr.startswith('source == "') and expr.endswith('"')
        literal = expr[len('source == "'):-1]
        value = literal.replace('\\"', '"').replace("\\\\", "\\")
        self.rows = [r for r in self.rows if r["source"] != value]

    @property
    def num_entities(self):
        return len(self.rows)


def _fake_pymilvus(monkeypatch):
    mod = types.ModuleType("pymilvus")
    mod.Collection = _FakeCollection
    mod.CollectionSchema = lambda fields: {"fields": fields}
    mod.DataType = types.SimpleNamespace(INT64="INT64", VARCHAR="VARCHAR",
                                         FLOAT_VECTOR="FLOAT_VECTOR")
    mod.FieldSchema = lambda name, dtype, **kw: {"name": name, "dtype": dtype, **kw}
    mod._connections = []
    mod.connections = types.SimpleNamespace(connect=lambda **kw: mod._connections.append(kw))
    mod.utility = types.SimpleNamespace()
    monkeypatch.setitem(sys.modules, "pymilvus", mod)
    _FakeCollection.instances.clear()
    _FakeCollection.calls = []
    return mod


# ------------------------------------------------------------------ //
# a fake psycopg2 that records every statement


class _FakeCursor:
    def __init__(self, db):
        self.db = db
        self._result = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def execute(self, sql, params=None):
        db = self.db
        db["sql"].append((sql, params))
        flat = " ".join(sql.split())
        if flat.startswith("CREATE EXTENSION"):
            db["extension"] = True
        elif flat.startswith("CREATE TABLE IF NOT EXISTS"):
            m = re.match(r"CREATE TABLE IF NOT EXISTS (\w+) .*vector\((\d+)\)", flat)
            db.setdefault("tables", {})[m.group(1)] = int(m.group(2))
            db.setdefault("rows", {}).setdefault(m.group(1), [])
        elif flat.startswith("INSERT INTO"):
            text, source, emb = params
            db["rows"][flat.split()[2]].append(
                {"text": text, "source": source, "vector": np.asarray(json.loads(emb))})
        elif "ORDER BY embedding <=>" in flat:
            table = re.search(r"FROM (\w+)", flat).group(1)
            q = np.asarray(json.loads(params[0]))
            rows = sorted(enumerate(db["rows"][table]),
                          key=lambda ir: (-float(ir[1]["vector"] @ q), ir[0]))[:int(params[2])]
            self._result = [(r["text"], r["source"], float(r["vector"] @ q)) for _, r in rows]
        elif flat.startswith("SELECT DISTINCT source"):
            table = re.search(r"FROM (\w+)", flat).group(1)
            self._result = [(s,) for s in sorted({r["source"] for r in db["rows"][table]})]
        elif flat.startswith("DELETE FROM"):
            table = flat.split()[2]
            db["rows"][table] = [r for r in db["rows"][table] if r["source"] != params[0]]
        elif flat.startswith("SELECT COUNT(*)"):
            table = re.search(r"FROM (\w+)", flat).group(1)
            self._result = [(len(db["rows"][table]),)]
        else:
            raise AssertionError(f"unexpected SQL: {flat}")

    def fetchall(self):
        return self._result

    def fetchone(self):
        return self._result[0]


class _FakeConn:
    def __init__(self, db):
        self.db = db

    def cursor(self):
        return _FakeCursor(self.db)

    def commit(self):
        self.db["sql"].append(("COMMIT", None))


def _fake_psycopg2(monkeypatch):
    mod = types.ModuleType("psycopg2")
    mod._db = {"sql": []}
    mod._connect_args = []

    def connect(**kw):
        mod._connect_args.append(kw)
        return _FakeConn(mod._db)

    mod.connect = connect
    monkeypatch.setitem(sys.modules, "psycopg2", mod)
    return mod


# ------------------------------------------------------------------ //
# the same traffic through both packages


def _traffic(seed, chunk_cls):
    rng = np.random.default_rng(seed)
    sources = ["a.txt", 'we"ird\\name.pdf', "b.md", "c d.html"]
    chunks = [chunk_cls(text=f"text {i} {int(rng.integers(1 << 16))}",
                        source=sources[int(rng.integers(len(sources)))]) for i in range(12)]
    emb = rng.standard_normal((12, 8)).astype(np.float32) * rng.uniform(0.5, 3.0, (12, 1))
    queries = rng.standard_normal((5, 8)).astype(np.float32)
    return chunks, emb.astype(np.float32), queries, sources


def _hits(hits):
    return [(h.chunk.text, h.chunk.source, h.score) for h in hits]


def _drive_milvus(pkg, seed, monkeypatch):
    mod = _fake_pymilvus(monkeypatch)
    milvus_cls, _, chunk_cls = PACKAGES[pkg]
    chunks, emb, queries, sources = _traffic(seed, chunk_cls)
    store = milvus_cls(dimensions=8, url="http://milvus-host:19530", collection="unit", nlist=32)
    store.add(chunks[:7], emb[:7])
    store.add(chunks[7:], emb[7:])
    out = {"hits": [_hits(store.search(q, 4, score_threshold=t))
                    for q in queries for t in (0.0, 0.3)],
           "sources": store.sources(), "count": store.count()}
    assert store.delete_sources([sources[1], "never-ingested"])
    out.update(after=store.sources(), count_after=store.count(),
               connections=mod._connections, calls=_FakeCollection.calls)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_milvus_makes_jax_s_calls_and_answers(seed, monkeypatch):
    got, want = _drive_milvus("port", seed, monkeypatch), _drive_milvus("jax", seed, monkeypatch)
    for key in ("sources", "count", "after", "count_after", "connections"):
        assert got[key] == want[key], key
    assert [c[:1] + c[2:] if c[0] == "insert" else c for c in got["calls"]] == \
        [c[:1] + c[2:] if c[0] == "insert" else c for c in want["calls"]]
    for g, w in zip(got["calls"], want["calls"]):  # the normalized vectors inserted
        if g[0] == "insert":
            assert g[1] == w[1] and np.abs(np.array(g[3]) - np.array(w[3])).max() <= SCORE_TOL
    for g, w in zip(got["hits"], want["hits"]):
        assert [h[:2] for h in g] == [h[:2] for h in w]
        assert max((abs(a[2] - b[2]) for a, b in zip(g, w)), default=0.0) <= SCORE_TOL
    assert got["connections"] == [{"host": "milvus-host", "port": "19530"}]
    schema = _FakeCollection.instances["unit"].schema
    assert [f["name"] for f in schema["fields"]] == ["pk", "text", "source", "vector"]
    assert ("delete", 'source == "we\\"ird\\\\name.pdf"') in got["calls"]
    assert ("create_index", "vector", {"index_type": "IVF_FLAT", "metric_type": "IP",
                                       "params": {"nlist": 32}}) in got["calls"]


def _drive_pg(pkg, seed, monkeypatch):
    mod = _fake_psycopg2(monkeypatch)
    _, pg_cls, chunk_cls = PACKAGES[pkg]
    chunks, emb, queries, sources = _traffic(seed, chunk_cls)
    store = pg_cls(dimensions=8, url="http://pg-host:5433", collection="unit")
    store.add(chunks, emb)
    out = {"hits": [_hits(store.search(q, 5, score_threshold=t))
                    for q in queries for t in (0.0, 0.3)],
           "sources": store.sources(), "count": store.count()}
    assert store.delete_sources(sources[:2])
    out.update(after=store.sources(), count_after=store.count(), connect=mod._connect_args,
               sql=mod._db["sql"])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pgvector_makes_jax_s_statements_and_answers(seed, monkeypatch):
    got, want = _drive_pg("port", seed, monkeypatch), _drive_pg("jax", seed, monkeypatch)
    for key in ("sources", "count", "after", "count_after", "connect"):
        assert got[key] == want[key], key
    assert [s for s, _ in got["sql"]] == [s for s, _ in want["sql"]]
    for (sql, gp), (_, wp) in zip(got["sql"], want["sql"]):
        if gp is None or not any(isinstance(p, str) and p.startswith("[") for p in gp):
            assert gp == wp, sql
        else:  # the JSON vectors: the same normalized floats
            for g, w in zip(gp, wp):
                if isinstance(g, str) and g.startswith("["):
                    assert np.abs(np.array(json.loads(g)) - np.array(json.loads(w))).max() \
                        <= SCORE_TOL
                else:
                    assert g == w
    for g, w in zip(got["hits"], want["hits"]):
        assert [h[:2] for h in g] == [h[:2] for h in w]
        assert max((abs(a[2] - b[2]) for a, b in zip(g, w)), default=0.0) <= SCORE_TOL
    assert got["connect"] == [{"host": "pg-host", "port": 5433, "user": "postgres",
                               "password": "password", "dbname": "api"}]
    assert got["sql"][1][0] == ("CREATE TABLE IF NOT EXISTS chunks_unit (id SERIAL PRIMARY KEY, "
                                "text TEXT, source TEXT, embedding vector(8))")


@pytest.mark.parametrize("module,store", [("pymilvus", 0), ("psycopg2", 1)])
def test_a_missing_client_raises_jax_s_message(monkeypatch, module, store):
    monkeypatch.setitem(sys.modules, module, None)
    with pytest.raises(VectorStoreError) as got:
        PACKAGES["port"][store](dimensions=4, url="http://x:1")
    with pytest.raises(JVectorStoreError) as want:
        PACKAGES["jax"][store](dimensions=4, url="http://x:1")
    assert str(got.value) == str(want.value)
    assert f"{module} is not installed; use vector_store.name=tpu" in str(got.value)


@pytest.mark.parametrize("name,url,cls", [
    ("milvus", "http://milvus:19530", "MilvusVectorStore"),
    ("MILVUS", "", "MilvusVectorStore"),
    ("pgvector", "pgvector:5432", "PgVectorStore"),
])
def test_the_factory_reaches_each_connector_with_the_url(monkeypatch, name, url, cls):
    mods = {"pymilvus": _fake_pymilvus(monkeypatch), "psycopg2": _fake_psycopg2(monkeypatch)}
    store = tstore.create_vector_store(name, 8, url=url, collection="col", device="cpu",
                                       ann_mode="exact", nlist=4, nprobe=2)
    assert type(store).__name__ == cls
    if cls == "MilvusVectorStore":
        host, _, port = url.replace("http://", "").partition(":")
        assert mods["pymilvus"]._connections == [{"host": host or "localhost",
                                                  "port": port or "19530"}]
        # JAX's factory passes no nlist/nprobe: the connector's defaults
        assert ("create_index", "vector", {"index_type": "IVF_FLAT", "metric_type": "IP",
                                           "params": {"nlist": 64}}) in _FakeCollection.calls
    else:
        assert mods["psycopg2"]._connect_args[0]["host"] == "pgvector"
        assert mods["psycopg2"]._connect_args[0]["port"] == 5432


def test_the_runtime_passes_the_configured_url(monkeypatch, tmp_path):
    from generativeaiexamples_tpu_torch import config as tconfig
    from generativeaiexamples_tpu_torch.chains import runtime

    mod = _fake_pymilvus(monkeypatch)
    env = {"APP_VECTORSTORE_NAME": "milvus", "APP_VECTORSTORE_URL": "http://milvus:19530",
           "APP_EMBEDDINGS_MODELENGINE": "hash", "APP_EMBEDDINGS_DIMENSIONS": "16"}
    for key in [k for k in list(__import__("os").environ) if k.startswith("APP_")]:
        monkeypatch.delenv(key)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    runtime.reset_runtime()
    runtime.set_device("cpu")
    tconfig.get_config.cache_clear()
    try:
        store = runtime.get_vector_store("conv")
        assert type(store).__name__ == "MilvusVectorStore"
        assert mod._connections == [{"host": "milvus", "port": "19530"}]
        assert ("Collection", "conv", _FakeCollection.instances["conv"].schema) in \
            _FakeCollection.calls
    finally:
        runtime.reset_runtime()
        runtime.set_device(None)
        tconfig.get_config.cache_clear()


def test_a_failing_milvus_search_opens_the_port_s_breaker(monkeypatch):
    """Searches retry behind the shared ``milvus`` breaker of the port's
    utils/resilience.py; failures past its threshold open it, and then a
    search fails fast with ``CircuitOpenError``."""
    _fake_pymilvus(monkeypatch)
    store = tmilvus.MilvusVectorStore(dimensions=4, url="http://m:1", collection="down")
    tries = []

    def down(*a, **k):
        tries.append(1)
        raise ConnectionError("milvus down")

    monkeypatch.setattr(_FakeCollection.instances["down"], "search", down)
    for _ in range(10):
        if tres.get_breaker("milvus").state == "open":
            break
        with pytest.raises(tres.DependencyUnavailable, match="milvus down"):
            store.search(np.ones(4, np.float32), 2)
    assert tres.get_breaker("milvus").state == "open" and len(tries) > 1
    seen = len(tries)
    with pytest.raises(tres.CircuitOpenError):
        store.search(np.ones(4, np.float32), 2)
    assert len(tries) == seen
