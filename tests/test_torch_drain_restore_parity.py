"""Drain and restore against the JAX engine: the port's streams, drained
mid-decode on one engine and restored on a second that shares only the
spool, equal the JAX package's LLMEngine's uninterrupted streams on the
same debug float32 weights (``models/convert.py``), short, one-chunk and
chunked prompts, on the paged layout: greedy and seeded with the float32
pool, greedy with the w8a8 + int8 KV recipe. Both engines compute in
float32 and w8a8's products are exact integer sums, so the streams must
be identical token for token.

The port's ``disagg`` policy is held against the JAX engine's own
``disagg`` the same way: the port's requests are submitted together, so
the prefill tier hands each one to the decode tier while the others
decode, and each stream must equal the JAX engine's, token for token
(float32, short, one-chunk and chunked prompts, greedy and seeded), with
one handoff a request and no recompute.

Slow tier: it builds and compiles a JAX engine."""
import time

import jax.numpy as jnp
import pytest

from generativeaiexamples_tpu.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine.llm_engine import LLMEngine as JaxEngine
from generativeaiexamples_tpu.engine.llm_engine import SamplingParams as JaxParams
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import request_snapshot as rs
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
from generativeaiexamples_tpu_torch.engine.scheduler import handoff as thandoff
from generativeaiexamples_tpu_torch.models.convert import params_from_jax
from generativeaiexamples_tpu_torch.utils import faults

pytestmark = pytest.mark.slow

COMMON = dict(model_config_name="debug", dtype="float32", max_batch_size=4, max_seq_len=128,
              prefill_chunk=16, page_size=8, decode_block=2)
PROMPTS = [[256, 72, 105], list(range(40, 56)), [256] + [(5 * i) % 250 for i in range(37)]]
KW = [dict(temperature=0.0, max_tokens=24), dict(temperature=0.9, top_p=0.8, max_tokens=24, seed=7),
      dict(temperature=0.0, max_tokens=24)]


@pytest.mark.parametrize("recipe", ["float32", "w8a8-int8"])
def test_restored_streams_equal_the_jax_engine_s_uninterrupted_streams(tmp_path, recipe):
    quant = dict(quantization="w8a8", kv_cache_dtype="int8") if recipe == "w8a8-int8" else {}
    # w8a8 rows greedy only: a seeded row's first token parts from the JAX
    # engine's after a monolithic w8a8 prefill, interrupted or not
    # (ROADMAP queue 3), as tests/test_torch_engine_parity.py's scope
    kws = [dict(kw, temperature=0.0) for kw in KW] if quant else KW
    jax_engine = JaxEngine(JaxEngineConfig(tensor_parallelism=1, kv_layout="paged",
                                           decode_runahead=1, **COMMON, **quant))
    try:
        weights = (jax_engine.params if quant
                   else jl.init_params_fast(jl.PRESETS["debug"], 0, jnp.float32))
        refs = [list(jax_engine.iter_ids(p, JaxParams(**kw), timeout=600))
                for p, kw in zip(PROMPTS, kws)]
    finally:
        jax_engine.shutdown()
    cfg = EngineConfig(kv_layout="paged", snapshot_spool_dir=str(tmp_path), **COMMON, **quant)
    params = params_from_jax(weights)
    e1 = LLMEngine(cfg, device="cpu", params=params)
    e2 = LLMEngine(cfg, device="cpu", params=params)
    try:
        faults.configure("engine.dispatch", "delay", at=1, count=0, value=0.05)
        try:
            with e1.hold_admissions():
                reqs = [e1.submit(p, SamplingParams(**kw)) for p, kw in zip(PROMPTS, kws)]
            deadline = time.time() + 120
            while not all(r.generated for r in reqs):
                assert time.time() < deadline
                time.sleep(0.005)
            summary = e1.drain()
        finally:
            faults.reset()
        assert summary["spooled"] == len(PROMPTS)
        for req, ref in zip(reqs, refs):
            snap = rs.RequestSnapshot.from_doc(e2.snapshot_spool.load_doc(req.error.snapshot_id))
            new, _, prior, mode = e2.restore_snapshot(snap)
            assert mode == "restore" and 1 <= len(prior) < len(ref)
            while new.out_queue.get(timeout=600) is not None:
                pass
            # the JAX stream drops stop ids, the transcript keeps them
            assert [t for t in new.emitted if t not in e2._stop_ids] == ref
    finally:
        e1.shutdown()
        e2.shutdown()


DISAGG_PROMPTS = PROMPTS + [[(7 * i) % 240 + 3 for i in range(29)]]
DISAGG_KW = KW + [dict(temperature=0.7, top_p=0.9, max_tokens=24, seed=11)]


def test_disagg_streams_equal_the_jax_engine_s_disagg_streams():
    jax_engine = JaxEngine(JaxEngineConfig(tensor_parallelism=1, kv_layout="paged",
                                           decode_runahead=1, scheduler_policy="disagg",
                                           **COMMON))
    try:
        assert jax_engine.scheduler.kind == "disagg"
        refs = [list(jax_engine.iter_ids(p, JaxParams(**kw), timeout=600))
                for p, kw in zip(DISAGG_PROMPTS, DISAGG_KW)]
    finally:
        jax_engine.shutdown()
    weights = jl.init_params_fast(jl.PRESETS["debug"], 0, jnp.float32)
    port = LLMEngine(EngineConfig(kv_layout="paged", scheduler_policy="disagg", **COMMON),
                     device="cpu", params=params_from_jax(weights))
    try:
        assert port.scheduler.kind == "disagg"
        before = thandoff.metrics_snapshot()
        reqs = [port.submit(p, SamplingParams(**kw)) for p, kw in zip(DISAGG_PROMPTS, DISAGG_KW)]
        for req in reqs:
            while req.out_queue.get(timeout=600) is not None:
                pass
        after = thandoff.metrics_snapshot()
        for req, ref in zip(reqs, refs):
            assert req.error is None
            assert [t for t in req.emitted if t not in port._stop_ids] == ref
        assert after["handoffs"] - before["handoffs"] == len(DISAGG_PROMPTS)
        assert after["handoff_recompute"] == before["handoff_recompute"]
    finally:
        assert port.shutdown()
