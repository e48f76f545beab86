"""``disagg`` and the retrieval tier beside a sharded engine (``mesh=`` of
``cpu`` shards).

- ``parallel.mesh.tier_submeshes`` splits a mesh as the JAX function
  does, for 1, 2, 4 and 8 devices: the same device positions in each tier
  (exact).
- ``disagg`` at TP=2 streams exactly what ``unified`` at TP=2 streams
  (float32 weights, short, one-chunk and chunked prompts, greedy and
  seeded, submitted together so the prefill tier hands each request over
  while the others decode), one handoff a request and no recompute, and
  ``describe()`` reports JAX's tier plan keys.
- The retrieval tier beside a TP=2 process engine that is decoding: a
  wave's answers equal the same query alone through the batched store
  path, and the synchronous path's within ``SCORE_TOL`` (1e-5) with tie
  runs as sets (tests/test_torch_retrieval_tier.py's rules).
"""
import jax
import pytest
import torch

from generativeaiexamples_tpu.parallel import mesh as jmesh
from generativeaiexamples_tpu_torch.chains import runtime as trt
from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import llm_engine, retrieval_tier
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
from generativeaiexamples_tpu_torch.engine.scheduler import handoff as thandoff
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.parallel import Mesh, create_mesh, tier_submeshes
from tests.test_torch_chain_runtime import runtimes  # noqa: F401 - a fixture
from tests.test_torch_retrieval_tier import (_alone_batched, _assert_close_to_synchronous,
                                             _concurrently, _queries, _tier)

COMMON = dict(model_config_name="debug-8dev", dtype="float32", max_batch_size=4, max_seq_len=128,
              prefill_chunk=16, page_size=8, decode_block=2, kv_layout="paged")
PROMPTS = [[256, 72, 105], list(range(40, 56)), [256] + [(5 * i) % 250 for i in range(37)],
           [(7 * i) % 240 + 3 for i in range(29)]]
KW = [dict(temperature=0.0, max_tokens=24), dict(temperature=0.9, top_p=0.8, max_tokens=24, seed=7),
      dict(temperature=0.0, max_tokens=24), dict(temperature=0.7, top_p=0.9, max_tokens=24, seed=11)]


def _mesh(n):
    return create_mesh(n, devices=["cpu"] * n)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_tier_submeshes_split_as_jax_s(n):
    jm = jmesh.create_mesh(tensor_parallelism=n, devices=jax.devices()[:n])
    jp, jd = jmesh.tier_submeshes(jm)
    port = Mesh([torch.device("cuda", i) for i in range(n)])
    tp_, td = tier_submeshes(port)
    assert [d.index for d in tp_.devices] == [d.id for d in jp.devices.reshape(-1)]
    assert [d.index for d in td.devices] == [d.id for d in jd.devices.reshape(-1)]
    assert (tp_.size, td.size) == (jp.size, jd.size)
    assert (tp_.devices == td.devices) == (jp.devices.tolist() == jd.devices.tolist())
    assert (n == 1) == (tp_ is port and td is port)


@pytest.fixture(scope="module")
def dense_weights():
    return llama.init_params(llama.PRESETS["debug-8dev"], 0, torch.float32)


def _together(eng):
    reqs = [eng.submit(p, SamplingParams(**k)) for p, k in zip(PROMPTS, KW)]
    for req in reqs:
        while req.out_queue.get(timeout=120) is not None:
            pass
        assert req.error is None
    return [list(r.emitted) for r in reqs]


def test_disagg_at_tp2_streams_as_unified_at_tp2(dense_weights):
    uni = LLMEngine(EngineConfig(**COMMON), params=dense_weights, mesh=_mesh(2))
    try:
        want = _together(uni)
    finally:
        uni.shutdown()
    eng = LLMEngine(EngineConfig(scheduler_policy="disagg", **COMMON), params=dense_weights,
                    mesh=_mesh(2))
    try:
        assert eng.scheduler.kind == "disagg" and eng.tp_shards == 2
        plan = eng.scheduler.describe()
        # two shards on one device: each tier one shard, one shared pool
        assert (plan["prefill_tier_devices"], plan["decode_tier_devices"]) == (1, 1)
        assert plan["shared_pool"] is True
        before = thandoff.metrics_snapshot()
        got = _together(eng)
        after = thandoff.metrics_snapshot()
    finally:
        assert eng.shutdown()
    assert got == want
    assert after["handoffs"] - before["handoffs"] == len(PROMPTS)
    assert after["handoff_recompute"] == before["handoff_recompute"]


@pytest.mark.parametrize("runtimes", ["dense", "hybrid"], indirect=True)
def test_the_tier_serves_beside_a_decoding_tp2_engine(runtimes, monkeypatch, dense_weights):
    _, tcfg, docs = runtimes
    queries = _queries(docs)
    alone = [_alone_batched(q, tcfg) for q in queries]
    eng = LLMEngine(EngineConfig(**COMMON), params=dense_weights, mesh=_mesh(2))
    monkeypatch.setattr(llm_engine, "_ENGINE", eng)
    try:
        long = eng.submit(PROMPTS[2], SamplingParams(temperature=0.0, max_tokens=64))
        tier_cfg = _tier(tcfg, tier_window_ms=200)
        before = dict(retrieval_tier.counters)
        got = _concurrently(lambda q: trt.retrieve(q, config=tier_cfg), queries)
        assert retrieval_tier.counters["queries"] - before.get("queries", 0) == len(queries)
        while long.out_queue.get(timeout=120) is not None:
            pass
        assert long.error is None and long.generated == 64
    finally:
        eng.shutdown()
    for q, g, a in zip(queries, got, alone):
        assert [(h.chunk.source, h.chunk.text, h.score) for h in g] == \
            [(h.chunk.source, h.chunk.text, h.score) for h in a]
        _assert_close_to_synchronous(q, g, tcfg)
