"""The port's native C++ index (generativeaiexamples_tpu_torch/csrc/
vecindex.cpp through retrieval/native_index.py) and its store
(retrieval/native_store.py) against the JAX package's (native/vecindex.cpp,
retrieval/native_index.py, retrieval/native_store.py).

Both libraries are built here with the host's g++ and the same flags. On
the same seeded unit vectors the two give identical ids and scores within
1e-6 (the same source and compiler: in practice bitwise) for flat search
under inner product and L2, and for IVF (the same seeded k-means) at every
probe count; removal and the unfilled slots match too. An index saved by
either library is the same bytes and loads in the other; a store either
package persisted opens in the other with the same hits. The factory
serves ``faiss``/``native``/``ivf`` with the native store, falls back to
the in-process store only where the library is unavailable (logged once,
with the error), and the library is keyed on the host CPU.
"""
import logging
import sys
import threading

import numpy as np
import pytest

from generativeaiexamples_tpu.retrieval import native_index as jni
from generativeaiexamples_tpu.retrieval import native_store as jns
from generativeaiexamples_tpu.retrieval.store import Chunk as JChunk
from generativeaiexamples_tpu_torch.ops._build import BUILD_DIR
from generativeaiexamples_tpu_torch.retrieval import native_index as tni
from generativeaiexamples_tpu_torch.retrieval import native_store as tns
from generativeaiexamples_tpu_torch.retrieval import store as tstore
from generativeaiexamples_tpu_torch.retrieval.errors import VectorStoreError
from generativeaiexamples_tpu_torch.retrieval.store import Chunk

SCORE_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def libraries():
    """Both libraries built with g++ (this machine has it)."""
    assert jni.available(), "the JAX package's native index did not build"
    assert tni.available(), f"the port's native index did not build: {tni.unavailable_reason()}"


def _unit(n, d, seed):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _same(got, want):
    (gs, gi), (ws, wi) = got, want
    assert np.array_equal(gi, wi)
    finite = np.isfinite(ws)
    assert np.array_equal(np.isfinite(gs), finite)
    assert np.abs(gs[finite] - ws[finite]).max(initial=0.0) <= SCORE_TOL


@pytest.mark.parametrize("metric", [jni.METRIC_IP, jni.METRIC_L2], ids=["ip", "l2"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flat_search_is_jax_s(metric, seed):
    d = 48
    base, queries = _unit(700, d, seed), _unit(25, d, seed + 100)
    j, t = jni.NativeIndex(d, metric), tni.NativeIndex(d, metric)
    assert j.add(base) == t.add(base) == 0
    assert len(t) == len(j) == 700 and t.is_trained
    for k in (1, 5, 16):
        _same(t.search(queries, k), j.search(queries, k))
    # the exact answer: numpy's ranking where scores are clear of each other
    scores, ids = t.search(queries, 1)
    ref = base @ queries.T if metric == tni.METRIC_IP else \
        -((base[:, None, :] - queries[None]) ** 2).sum(-1)
    assert np.array_equal(ids[:, 0], ref.argmax(0))


@pytest.mark.parametrize("nprobe", [1, 4, 8, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_ivf_search_is_jax_s(nprobe, seed):
    d, nlist = 32, 16
    base, queries = _unit(1500, d, seed), _unit(40, d, seed + 7)
    j, t = jni.NativeIndex(d, jni.METRIC_IP, nlist), tni.NativeIndex(d, tni.METRIC_IP, nlist)
    assert not t.is_trained
    with pytest.raises(RuntimeError, match="not trained"):
        t.add(base[:2])
    j.train(base, iters=5, seed=seed)
    t.train(base, iters=5, seed=seed)
    assert j.add(base) == t.add(base) == 0
    _same(t.search(queries, 8, nprobe=nprobe), j.search(queries, 8, nprobe=nprobe))
    if nprobe == nlist:  # every list probed: exact
        assert np.array_equal(t.search(queries, 1, nprobe)[1][:, 0], (base @ queries.T).argmax(0))


def test_remove_and_unfilled_slots_are_jax_s():
    d = 16
    base = _unit(30, d, 3)
    j, t = jni.NativeIndex(d), tni.NativeIndex(d)
    j.add(base)
    t.add(base)
    doomed = np.array([0, 5, 29, 5, 77], np.int64)
    assert t.remove(doomed) == j.remove(doomed) == 3
    assert len(t) == len(j) == 27
    got, want = t.search(base[:4], 40), j.search(base[:4], 40)
    _same(got, want)
    assert (got[1][:, 27:] == -1).all() and np.isneginf(got[0][:, 27:]).all()
    assert t.add(base[:2]) == j.add(base[:2]) == 30  # ids stay sequential


@pytest.mark.parametrize("nlist", [0, 8], ids=["flat", "ivf"])
def test_saved_indexes_are_the_same_bytes_and_load_across(tmp_path, nlist):
    d = 24
    base, queries = _unit(400, d, 5), _unit(10, d, 6)
    j, t = jni.NativeIndex(d, jni.METRIC_IP, nlist), tni.NativeIndex(d, tni.METRIC_IP, nlist)
    if nlist:
        j.train(base, iters=4)
        t.train(base, iters=4)
    j.add(base)
    t.add(base)
    j.remove([3, 4])
    t.remove([3, 4])
    j.save(str(tmp_path / "j.vecidx"))
    t.save(str(tmp_path / "t.vecidx"))
    assert (tmp_path / "j.vecidx").read_bytes() == (tmp_path / "t.vecidx").read_bytes()
    t_from_j = tni.NativeIndex.load(str(tmp_path / "j.vecidx"))
    j_from_t = jni.NativeIndex.load(str(tmp_path / "t.vecidx"))
    assert t_from_j.dim == d and len(t_from_j) == len(j_from_t) == 398
    want = j.search(queries, 6, nprobe=4)
    _same(t_from_j.search(queries, 6, nprobe=4), want)
    _same(j_from_t.search(queries, 6, nprobe=4), want)
    t_from_j.save(str(tmp_path / "again.vecidx"))
    assert (tmp_path / "again.vecidx").read_bytes() == (tmp_path / "j.vecidx").read_bytes()
    with pytest.raises(IOError, match="failed to load"):
        tni.NativeIndex.load(str(tmp_path / "missing.vecidx"))


def _chunks(cls, n, seed):
    rng = np.random.default_rng(seed)
    return [cls(text=f"chunk {i} {int(rng.integers(1 << 20))}", source=f"doc{i % 7}.txt",
                metadata={"page": str(i % 3)}) for i in range(n)]


def _hits(hits):
    return [(h.chunk.text, h.chunk.source, dict(h.chunk.metadata), h.score) for h in hits]


def _assert_same_hits(got, want):
    assert [h[:3] for h in _hits(got)] == [h[:3] for h in _hits(want)]
    assert max((abs(a.score - b.score) for a, b in zip(got, want)), default=0.0) <= SCORE_TOL


@pytest.mark.parametrize("nlist", [0, 64], ids=["faiss", "ivf"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_persisted_store_opens_in_the_other_package(tmp_path, nlist, writer):
    d = 40
    emb, queries = _unit(260, d, 8) * 3.0, _unit(12, d, 9)  # unnormalized in
    j = jns.NativeVectorStore(d, persist_dir=str(tmp_path / "j"), collection="c", nlist=nlist)
    t = tns.NativeVectorStore(d, persist_dir=str(tmp_path / "t"), collection="c", nlist=nlist)
    j.add(_chunks(JChunk, 200, 1), emb[:200])
    t.add(_chunks(Chunk, 200, 1), emb[:200])
    j.add(_chunks(JChunk, 60, 2), emb[200:])
    t.add(_chunks(Chunk, 60, 2), emb[200:])
    assert j.delete_sources(["doc3.txt"]) and t.delete_sources(["doc3.txt"])
    assert t.sources() == j.sources() and t.count() == j.count()
    for q in queries:
        _assert_same_hits(t.search(q, 5, 0.1), j.search(q, 5, 0.1))
    # reopen what one package wrote with the other's store
    src = tmp_path / ("j" if writer == "jax" else "t")
    for name in ("c.vecidx", "c.meta.jsonl"):
        assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes()
    other = (tns.NativeVectorStore if writer == "jax" else jns.NativeVectorStore)(
        d, persist_dir=str(src), collection="c", nlist=nlist)
    mine = t if writer == "port" else j
    assert other.count() == mine.count() and other.sources() == mine.sources()
    for q in queries:
        _assert_same_hits(other.search(q, 5), mine.search(q, 5))


def test_corrupt_state_raises_jax_s_error(tmp_path):
    (tmp_path / "c.vecidx").write_bytes(b"not an index")
    with pytest.raises(VectorStoreError) as got:
        tns.NativeVectorStore(8, persist_dir=str(tmp_path), collection="c")
    with pytest.raises(Exception) as want:
        jns.NativeVectorStore(8, persist_dir=str(tmp_path), collection="c")
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith(f"Corrupt native store state in {tmp_path}")


def test_bad_shapes_raise_jax_s_errors():
    t, j = tns.NativeVectorStore(8), jns.NativeVectorStore(8)
    for chunks, emb in (([Chunk("a", "s")], np.zeros((1, 4))),
                        ([Chunk("a", "s")] * 2, np.ones((1, 8)))):
        with pytest.raises(VectorStoreError) as got:
            t.add(chunks, emb)
        with pytest.raises(Exception) as want:
            j.add(chunks, emb)
        assert str(got.value) == str(want.value)
    assert t.search(np.ones(8), 3) == [] and t.search(np.ones(8), 0) == []


@pytest.mark.parametrize("name,nlist", [("faiss", 0), ("native", 0), ("ivf", 64), ("FAISS", 0)])
def test_the_factory_serves_the_native_names(tmp_path, name, nlist):
    store = tstore.create_vector_store(name, 16, persist_dir=str(tmp_path), collection="x",
                                       device="cpu", ann_mode="exact")
    assert isinstance(store, tns.NativeVectorStore) and store._nlist == nlist
    assert store._nprobe == 8 and store._collection == "x"


def test_the_fallback_serves_the_in_process_store_and_logs_once(tmp_path, monkeypatch, caplog):
    from generativeaiexamples_tpu_torch.retrieval.torch_store import TorchVectorStore

    monkeypatch.setattr(tni, "available", lambda: False)
    monkeypatch.setattr(tni, "_ERROR", "native build failed: g++ missing")
    monkeypatch.setattr(tstore, "_FALLBACK_LOGGED", False)
    with caplog.at_level(logging.WARNING, logger=tstore.logger.name):
        for i in range(3):
            store = tstore.create_vector_store("faiss", 16, persist_dir=str(tmp_path / str(i)),
                                               device="cpu", ann_mode="exact")
            assert isinstance(store, TorchVectorStore)
    logged = [r.getMessage() for r in caplog.records if "native index is unavailable" in r.message]
    assert logged == ["vector store 'faiss': the native index is unavailable (native build "
                      "failed: g++ missing); serving the in-process store instead"]


def test_the_library_is_keyed_on_source_flags_and_cpu(monkeypatch):
    path = tni.library_path()
    assert path.parent == BUILD_DIR and path.name.startswith("vecindex-") and path.exists()
    assert tni.FLAGS == ["-O3", "-march=native", "-ffast-math", "-fPIC", "-shared", "-std=c++17"]
    monkeypatch.setattr(tni, "_host_cpu", lambda: "another cpu")
    assert tni.library_path() != path
    monkeypatch.undo()
    monkeypatch.setenv("CXX", "clang++")
    assert tni.library_path() != path


def test_a_failed_build_raises_native_unavailable(monkeypatch, tmp_path):
    monkeypatch.setattr(tni, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(tni.NativeUnavailable, match="native build failed"):
        tni.ensure_built()
    assert not list(tmp_path.glob("*.tmp"))


def test_a_closed_index_refuses_calls():
    t = tni.NativeIndex(4)
    t.close()
    t.close()
    with pytest.raises(ValueError, match="closed"):
        t.search(np.ones((1, 4)), 1)
    with pytest.raises(ValueError, match=r"expected \[N, 4\]"):
        tni.NativeIndex(4).add(np.ones((2, 3)))


def test_concurrent_adds_and_searches_keep_the_index_whole():
    """Worker threads add and search one store at once (ctypes releases the
    GIL inside each call; the index's lock serializes them)."""
    d, per, workers = 16, 40, 8
    store = tns.NativeVectorStore(d)
    vecs = _unit(per * workers, d, 11)
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def work(w):
        try:
            for i in range(per):
                row = w * per + i
                store.add([Chunk(f"t{row}", f"s{w}")], vecs[row:row + 1])
                hits = store.search(vecs[row], 1)
                assert hits and hits[0].chunk.text == f"t{row}"
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(w,)) for w in range(workers)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert store.count() == len(store._index) == per * workers
    ids = store._index.search(vecs, 1)[1][:, 0]
    assert sorted(ids.tolist()) == list(range(per * workers))
