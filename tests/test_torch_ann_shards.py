"""The ANN store's shard merge over a mesh (retrieval/ann.py,
retrieval/torch_store.py ``mesh=``) against the JAX package's
``_merge_shard_topk`` and its sharded engine, and against the port's own
one-shard search, exact and IVF: the corpus rows, the ``valid`` mask and
the IVF assignments cut over the mesh's ``model`` shards (``cpu`` devices
here), each shard's partial top-k, the merge with indices offset by
``shard x per``; a capacity the shards do not divide falls back to one
shard with JAX's warning.

Tolerance: scores are the same f32 dot products of unit vectors, summed
in other orders: within 1e-5 (tests/test_torch_retrieval.py's TOL);
indices equal except inside a run of tied scores, where any member may
come first."""
import logging

import jax
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.parallel.mesh import create_mesh as jcreate_mesh
from generativeaiexamples_tpu.retrieval import ann as jann
from generativeaiexamples_tpu_torch.parallel import create_mesh
from generativeaiexamples_tpu_torch.retrieval import ann as tann
from generativeaiexamples_tpu_torch.retrieval.store import Chunk
from generativeaiexamples_tpu_torch.retrieval.torch_store import TorchVectorStore
from tests.test_torch_retrieval import D, _assert_same_topk, _unit


def _mesh(n):
    return create_mesh(n, devices=["cpu"] * n)


def _jax_sharded(mode, corpus, queries, k, shards, nlist=16, nprobe=4):
    """JAX's jitted programs, ``_merge_shard_topk`` at ``shards``, over the
    padded corpus the port builds."""
    rows = corpus.shape[0]
    cap = jann.capacity_rung(rows)
    padded = np.zeros((cap, D), np.float32)
    padded[:rows] = corpus
    valid = np.zeros(cap, bool)
    valid[:rows] = True
    exact_topk, ivf_topk = jann._jitted_fns()
    kr = jann.k_rung(k, cap)
    if mode == "exact":
        s, i = exact_topk(padded, valid, queries, kr, shards)
    else:
        cents, assign = jann._kmeans(corpus, min(nlist, rows), seed=0)
        assign_pad = np.full(cap, min(nlist, rows), np.int32)
        assign_pad[:rows] = assign
        s, i = ivf_topk(padded, valid, assign_pad, cents, queries, kr, shards, nprobe)
    return np.asarray(s)[:, :k], np.asarray(i)[:, :k]


@pytest.mark.parametrize("mode", ["exact", "ivf"])
@pytest.mark.parametrize("shards,rows,k", [(2, 700, 4), (2, 3000, 16), (4, 1500, 16),
                                           (4, 5, 16), (8, 2000, 512)])
def test_sharded_search_is_jax_s_merge_and_the_one_shard_search(mode, shards, rows, k):
    """8 queries: the sharded engine's top-k equals JAX's programs at the
    same shard count and the port's one-shard engine; k above a shard's
    rows (k 512 over 8 shards of 256) takes each shard's whole slice."""
    rng = np.random.default_rng(rows * shards + k)
    corpus, queries = _unit(rng, rows), _unit(rng, 8)
    sharded = tann.ANNSearchEngine(D, mode=mode, nlist=16, nprobe=4, mesh=_mesh(shards))
    one = tann.ANNSearchEngine(D, mode=mode, nlist=16, nprobe=4, device="cpu")
    for eng in (sharded, one):
        eng.refresh(corpus, version=1)
    assert sharded.describe()["shards"] == shards and one.describe()["shards"] == 1
    corp = sharded._corpus
    assert [m.shape[0] for m, _, _ in corp.parts] == [corp.capacity // shards] * shards
    got = sharded.search(queries, k)
    want = _jax_sharded(mode, corpus, queries, min(k, rows), shards)
    _assert_same_topk(*got, *want)
    _assert_same_topk(*got, *one.search(queries, k))
    # pad_rows keeps its meaning: every dispatch max_batch rows
    _assert_same_topk(*sharded.search(queries[:3], k, pad_rows=True), got[0][:3], got[1][:3])


@pytest.mark.parametrize("mode", ["exact", "ivf"])
def test_the_sharded_engine_matches_jax_s_on_a_mesh(mode):
    """The whole JAX engine on a 2-device mesh (its corpus row-sharded on
    ``model``) against the port's on 2 ``cpu`` shards, 19 queries through
    max_batch 8."""
    rng = np.random.default_rng(23)
    corpus, queries = _unit(rng, 1500), _unit(rng, 19)
    jmesh = jcreate_mesh(tensor_parallelism=2, devices=jax.devices()[:2])
    j = jann.ANNSearchEngine(D, mode=mode, nlist=32, nprobe=8, max_batch=8, mesh=jmesh)
    t = tann.ANNSearchEngine(D, mode=mode, nlist=32, nprobe=8, max_batch=8, mesh=_mesh(2))
    j.refresh(corpus, version=3)
    t.refresh(corpus, version=3)
    _assert_same_topk(*t.search(queries, 10), *j.search(queries, 10))
    keys = ("mode", "rows", "capacity", "shards", "max_batch")
    assert {k: t.describe()[k] for k in keys} == {k: j.describe()[k] for k in keys}
    assert t.describe()["shards"] == 2


def test_a_capacity_the_shards_do_not_divide_falls_back_to_one_shard(caplog):
    """Three shards and a 1024-row capacity: one shard, JAX's warning, the
    one-shard results; JAX's engine on three devices does the same."""
    rng = np.random.default_rng(5)
    corpus, queries = _unit(rng, 600), _unit(rng, 4)
    jmesh = jcreate_mesh(tensor_parallelism=3, devices=jax.devices()[:3])
    j = jann.ANNSearchEngine(D, mode="exact", mesh=jmesh)
    j.refresh(corpus, version=1)
    with caplog.at_level(logging.WARNING, logger="generativeaiexamples_tpu_torch.retrieval.ann"):
        t = tann.ANNSearchEngine(D, mode="exact", mesh=_mesh(3))
        t.refresh(corpus, version=1)
    assert ("ANN capacity 1024 not divisible by model-axis size 3; falling back to unsharded "
            "search") in caplog.text
    assert t.describe()["shards"] == j.describe()["shards"] == 1
    assert len(t._corpus.parts) == 1
    _assert_same_topk(*t.search(queries, 8), *j.search(queries, 8))


def test_merge_shard_topk_offsets_each_shard_s_indices():
    """The merge alone: per-shard partial lists of distinct scores, their
    local indices offset by ``shard x per``, equal JAX's merge of the
    whole score matrix; a tied run keeps its members as a set."""
    rng = np.random.default_rng(9)
    rows, shards, per, k = 3, 4, 16, 6
    scores = rng.permutation(rows * shards * per).reshape(rows, shards * per).astype(np.float32)
    scores[0, [3, 20, 40]] = 500.0  # one run of ties across three shards
    want_s, want_i = jann._merge_shard_topk(scores, k, shards)
    parts = [torch.topk(torch.from_numpy(scores[:, s * per:(s + 1) * per]), min(k, per), dim=1)
             for s in range(shards)]
    got_s, got_i = tann._merge_shard_topk(parts, k, per)
    _assert_same_topk(got_s.numpy(), got_i.numpy(), np.asarray(want_s), np.asarray(want_i))
    assert set(got_i[0, :3].tolist()) == {3, 20, 40}


def test_the_store_takes_a_mesh():
    rng = np.random.default_rng(2)
    vecs = _unit(rng, 300)
    chunks = [Chunk(text=f"t{i}", source=f"s{i % 7}") for i in range(300)]
    one = TorchVectorStore(D, device="cpu")
    sharded = TorchVectorStore(D, mesh=_mesh(2), ann_mode="ivf", nlist=8, nprobe=8)
    exact_sharded = TorchVectorStore(D, mesh=_mesh(2))
    for store in (one, sharded, exact_sharded):
        store.add(chunks, vecs)
    assert sharded.device == torch.device("cpu")
    assert exact_sharded._ann_engine().describe()["shards"] == 2
    queries = _unit(rng, 5)
    want = one.search_batch(queries, 6)
    for store in (sharded, exact_sharded):  # IVF with every list probed is exact
        got = store.search_batch(queries, 6)
        for g, w in zip(got, want):
            assert [h.chunk.text for h in g] == [h.chunk.text for h in w]
            np.testing.assert_allclose([h.score for h in g], [h.score for h in w], atol=1e-5)
