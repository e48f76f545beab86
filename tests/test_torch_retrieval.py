"""The port's retrieval layer (generativeaiexamples_tpu_torch/retrieval/)
against the JAX package's, on the CPU.

- ``_kmeans``: assignments and centroids bitwise JAX's (the same numpy);
- ``ANNSearchEngine`` exact against JAX's ``exact_topk`` and IVF against
  ``ivf_topk`` (retrieval/ann.py's jitted programs) on the same seeded
  corpus and the same padded shapes: scores within 1e-5 (f32 dot products
  of unit vectors summed in other orders), and indices equal wherever the
  next score is more than 1e-5 away; within a tie the hit sets agree;
- the capacity and k rungs equal JAX's;
- ``TorchVectorStore``: add/search/search_batch/sources/delete_sources/
  count, persistence, and a store persisted by JAX's ``TPUVectorStore``
  loading in the port with the same hits (scores within 1e-5).
"""
import numpy as np
import pytest

from generativeaiexamples_tpu.retrieval import ann as jann
from generativeaiexamples_tpu.retrieval.store import Chunk as JChunk
from generativeaiexamples_tpu.retrieval.tpu_store import TPUVectorStore
from generativeaiexamples_tpu_torch.retrieval import ann as tann
from generativeaiexamples_tpu_torch.retrieval.errors import VectorStoreError
from generativeaiexamples_tpu_torch.retrieval.store import Chunk, create_vector_store
from generativeaiexamples_tpu_torch.retrieval.torch_store import TorchVectorStore

TOL = 1e-5
D = 32


def _unit(rng, n, d=D):
    m = rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def _assert_same_topk(got_s, got_i, want_s, want_i):
    got_s, want_s = np.asarray(got_s), np.asarray(want_s)
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    assert got_s.shape == want_s.shape == got_i.shape
    finite = np.isfinite(want_s)
    assert np.array_equal(finite, np.isfinite(got_s))
    assert np.abs(got_s[finite] - want_s[finite]).max(initial=0.0) <= TOL
    for r in range(want_s.shape[0]):
        k = int(finite[r].sum())
        for j in range(k):
            gap = min(abs(want_s[r, j] - want_s[r, j - 1]) if j else np.inf,
                      abs(want_s[r, j] - want_s[r, j + 1]) if j + 1 < k else np.inf)
            if gap > TOL:
                assert got_i[r, j] == want_i[r, j], (r, j)
        # inside a tie, any member may come first: every hit scoring clearly
        # above the last one kept is kept
        sure = {int(want_i[r, j]) for j in range(k) if want_s[r, j] > want_s[r, k - 1] + TOL}
        assert sure <= set(got_i[r, :k].tolist()), r


@pytest.mark.parametrize("n,nlist", [(500, 16), (2000, 64), (10, 64), (64, 64)])
def test_kmeans_is_bitwise_jax(n, nlist):
    m = _unit(np.random.default_rng(n), n)
    c_t, a_t = tann._kmeans(m, nlist, seed=3)
    c_j, a_j = jann._kmeans(m, nlist, seed=3)
    assert a_t.dtype == a_j.dtype and np.array_equal(a_t, a_j)
    assert c_t.tobytes() == c_j.tobytes()


def test_rungs_equal_jax():
    for n in (1, 2, 3, 1000, 1024, 1025, 65536, 70000):
        assert tann.pow2_rung(n) == jann.pow2_rung(n)
        assert tann.capacity_rung(n) == jann.capacity_rung(n)
        assert tann.capacity_rung(n, floor=16) == jann.capacity_rung(n, floor=16)
    for cap in (1, 16, 1024):
        for k in (1, 3, 4, 17, 64, 5000):
            assert tann.k_rung(k, cap) == jann.k_rung(k, cap)
        assert tann.k_ladder(cap) == jann.k_ladder(cap)
        assert tann.k_ladder(cap, max_k=8) == jann.k_ladder(cap, max_k=8)


def _jax_reference(mode, corpus, queries, k, nlist=16, nprobe=4):
    """JAX's jitted programs over the same padded corpus the port builds."""
    rows = corpus.shape[0]
    cap = jann.capacity_rung(rows)
    padded = np.zeros((cap, D), np.float32)
    padded[:rows] = corpus
    valid = np.zeros(cap, bool)
    valid[:rows] = True
    exact_topk, ivf_topk = jann._jitted_fns()
    kr = jann.k_rung(k, cap)
    if mode == "exact":
        s, i = exact_topk(padded, valid, queries, kr, 1)
    else:
        cents, assign = jann._kmeans(corpus, min(nlist, rows), seed=0)
        assign_pad = np.full(cap, min(nlist, rows), np.int32)
        assign_pad[:rows] = assign
        s, i = ivf_topk(padded, valid, assign_pad, cents, queries, kr, 1, nprobe)
    return np.asarray(s)[:, :k], np.asarray(i)[:, :k]


@pytest.mark.parametrize("mode", ["exact", "ivf"])
@pytest.mark.parametrize("rows,k,nq", [(700, 4, 1), (700, 16, 8), (3000, 16, 8), (5, 16, 3)])
def test_ann_engine_matches_jax_programs(mode, rows, k, nq):
    rng = np.random.default_rng(rows + k)
    corpus, queries = _unit(rng, rows), _unit(rng, 8)[:nq]
    eng = tann.ANNSearchEngine(D, mode=mode, nlist=16, nprobe=4, device="cpu")
    eng.refresh(corpus, version=1)
    got_s, got_i = eng.search(queries, k)
    q = np.zeros((tann.pow2_rung(nq) if nq < 8 else 8, D), np.float32)
    q[:nq] = queries
    want_s, want_i = _jax_reference(mode, corpus, q, min(k, rows), nlist=16, nprobe=4)
    _assert_same_topk(got_s, got_i, want_s[:nq], want_i[:nq])
    assert got_i.dtype == np.int64 and got_s.shape == (nq, min(k, rows))


@pytest.mark.parametrize("mode", ["exact", "ivf"])
def test_ann_engine_matches_the_jax_engine(mode):
    """The whole JAX ``ANNSearchEngine`` (its refresh, rungs and chunking
    over max_batch) against the port's, 19 queries through max_batch 8."""
    rng = np.random.default_rng(11)
    corpus, queries = _unit(rng, 1500), _unit(rng, 19)
    j = jann.ANNSearchEngine(D, mode=mode, nlist=32, nprobe=8, max_batch=8)
    t = tann.ANNSearchEngine(D, mode=mode, nlist=32, nprobe=8, max_batch=8, device="cpu")
    j.refresh(corpus, version=7)
    t.refresh(corpus, version=7)
    _assert_same_topk(*t.search(queries, 10), *j.search(queries, 10))
    desc = t.describe()
    assert {k: desc[k] for k in ("mode", "rows", "capacity", "shards", "max_batch")} == {
        k: j.describe()[k] for k in ("mode", "rows", "capacity", "shards", "max_batch")}


def test_ivf_with_every_list_probed_is_exact():
    rng = np.random.default_rng(4)
    corpus, queries = _unit(rng, 900), _unit(rng, 6)
    exact = tann.ANNSearchEngine(D, mode="exact", device="cpu")
    ivf = tann.ANNSearchEngine(D, mode="ivf", nlist=8, nprobe=8, device="cpu")
    for e in (exact, ivf):
        e.refresh(corpus, version=1)
    _assert_same_topk(*ivf.search(queries, 12), *exact.search(queries, 12))


def test_ann_engine_refresh_and_edges():
    eng = tann.ANNSearchEngine(D, device="cpu")
    s, i = eng.search(_unit(np.random.default_rng(0), 2), 4)
    assert s.shape == (2, 0) and i.shape == (2, 0)  # nothing resident yet
    corpus = _unit(np.random.default_rng(1), 3)
    eng.refresh(corpus, version=1)
    before = eng._corpus
    eng.refresh(corpus * 0, version=1)  # same version: a no-op
    assert eng._corpus is before
    s, i = eng.search(corpus, 10)
    assert s.shape == (3, 3) and np.array_equal(i[:, 0], [0, 1, 2])  # k clamps to live rows
    assert eng.describe()["capacity"] == 1024
    with pytest.raises(ValueError, match="expected"):
        eng.search(np.zeros((1, D + 1), np.float32), 1)
    with pytest.raises(ValueError, match="ann mode"):
        tann.ANNSearchEngine(D, mode="hnsw", device="cpu")


def _chunks(n, prefix="doc"):
    return [Chunk(text=f"{prefix} text {i}", source=f"{prefix}{i % 3}.txt", metadata={"i": str(i)})
            for i in range(n)]


def test_store_add_search_delete_count(tmp_path):
    rng = np.random.default_rng(2)
    store = TorchVectorStore(D, persist_dir=str(tmp_path), device="cpu")
    emb = _unit(rng, 30) * 3.0  # the store normalizes
    store.add(_chunks(30), emb)
    assert store.count() == 30
    assert store.sources() == ["doc0.txt", "doc1.txt", "doc2.txt"]
    hits = store.search(emb[7], top_k=3)
    assert hits[0].chunk.text == "doc text 7" and hits[0].score == pytest.approx(1.0, abs=1e-5)
    assert all(0.0 <= h.score <= 1.0 + TOL for h in hits)  # clamped below only, as in JAX
    assert store.search(emb[7], top_k=5, score_threshold=0.999)[0].chunk.text == "doc text 7"
    batch = store.search_batch(emb[:4], top_k=2)
    assert [b[0].chunk.text for b in batch] == [f"doc text {i}" for i in range(4)]
    assert store.delete_sources(["doc1.txt"]) is True
    assert store.count() == 20 and "doc1.txt" not in store.sources()
    assert all(h.chunk.source != "doc1.txt" for h in store.search(emb[1], top_k=30))
    with pytest.raises(VectorStoreError, match="Expected"):
        store.add(_chunks(1), np.zeros((1, D + 1), np.float32))
    with pytest.raises(VectorStoreError, match="mismatch"):
        store.add(_chunks(2), _unit(rng, 1))
    again = TorchVectorStore(D, persist_dir=str(tmp_path), device="cpu")
    assert again.count() == 20 and again.sources() == ["doc0.txt", "doc2.txt"]
    assert [h.chunk for h in again.search(emb[0], top_k=4)] == [h.chunk for h in store.search(emb[0], top_k=4)]


@pytest.mark.parametrize("mode", ["exact", "ivf"])
def test_a_store_persisted_by_jax_loads_in_the_port(tmp_path, mode):
    rng = np.random.default_rng(9)
    emb = _unit(rng, 1200)
    jstore = TPUVectorStore(D, persist_dir=str(tmp_path), ann_mode=mode, nlist=16, nprobe=4)
    jstore.add([JChunk(text=f"t{i}", source=f"s{i % 5}", metadata={"k": str(i)}) for i in range(1000)],
               emb[:1000])
    jstore.add([JChunk(text=f"t{i}", source=f"s{i % 5}") for i in range(1000, 1200)], emb[1000:])
    port = TorchVectorStore(D, persist_dir=str(tmp_path), ann_mode=mode, nlist=16, nprobe=4,
                            device="cpu")
    assert port.count() == 1200 and port.sources() == jstore.sources()
    queries = _unit(rng, 5)
    for q in queries:
        want, got = jstore.search(q, top_k=8), port.search(q, top_k=8)
        assert len(got) == len(want)
        assert max(abs(g.score - w.score) for g, w in zip(got, want)) <= TOL
        assert {g.chunk.text for g in got} == {w.chunk.text for w in want}
    # and the port writes what JAX reads
    port.add([Chunk(text="new", source="s9")], _unit(rng, 1))
    reread = TPUVectorStore(D, persist_dir=str(tmp_path))
    assert reread.count() == 1201 and reread.sources()[-1] == "s9"


def test_create_vector_store_serves_the_jax_in_process_names(tmp_path):
    for name in ("tpu", "memory", "", None):
        store = create_vector_store(name, D, persist_dir=str(tmp_path / str(name)), device="cpu",
                                    ann_mode="ivf", nlist=8, nprobe=2)
        assert isinstance(store, TorchVectorStore) and store._ann_opts["mode"] == "ivf"
    for name in ("faiss", "milvus", "pgvector"):
        with pytest.raises(ValueError, match="queue 1 item 7"):
            create_vector_store(name, D)
    with pytest.raises(ValueError, match="Unknown vector store"):
        create_vector_store("elastic", D)
