"""The port's serving engine on the CPU (every kernel wrapper runs its plain
version): greedy streams equal a model-level greedy loop over the same
weights, long prompts take the chunked path, pages return to the
allocator, sampling is keyed by (seed, position), and the engine refuses
to start without a card unless asked for the CPU. Plus the pieces it is
built from: the page allocator, the config checks and the sampler."""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import sampling as jsampling
from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import kv_pages
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
from generativeaiexamples_tpu_torch.models import llama, sampling

PAGE = 8
CONFIG = dict(
    model_config_name="debug", dtype="float32", max_batch_size=3, max_seq_len=128,
    prefill_chunk=16, page_size=PAGE, decode_block=4,
)


@pytest.fixture(scope="module")
def engine():
    eng = LLMEngine(EngineConfig(**CONFIG), device="cpu")
    yield eng
    assert eng.shutdown()


def reference_greedy(eng, prompt, max_tokens):
    """Monolithic prefill + one decode step at a time, straight through the
    model functions, stopping where the engine stops."""
    cfg, params = eng.model_config, eng.params
    pmax = eng.max_seq_len // PAGE
    pool = llama.init_kv_pool(cfg, 1 + pmax, PAGE, torch.float32)
    tables = torch.arange(1, 1 + pmax, dtype=torch.int32)[None]
    logits, kvs = llama.prefill_layers(
        params, cfg, torch.tensor([prompt]), torch.tensor([len(prompt)]), use_flash=False
    )
    llama.write_prefill_pages(pool, kvs, tables, PAGE)
    stops = set(eng.tokenizer.stop_ids())
    out, pos = [], len(prompt)
    while True:
        tok = int(torch.argmax(logits[0, : eng._sample_vocab]))
        if tok in stops:
            return out
        out.append(tok)
        if len(out) >= max_tokens or pos >= eng.max_seq_len - 1:
            return out
        logits, _ = llama.decode_layers_paged(
            params, cfg, torch.tensor([tok]), torch.tensor([pos]), torch.tensor([True]),
            tables, pool, window=eng.max_seq_len, page_size=PAGE, page_kernel=False,
        )
        pos += 1


PROMPTS = [
    [256, 5, 6, 7],  # short: monolithic wave
    list(range(30, 46)),  # exactly one chunk
    [256] + [(3 * i) % 250 for i in range(40)],  # longer than prefill_chunk: chunked
]


def _drain(q, timeout=120):
    out = []
    while (tok := q.get(timeout=timeout)) is not None:
        out.append(tok)
    return out


def test_greedy_streams_equal_the_model_level_loop(engine):
    params = SamplingParams(temperature=0.0, max_tokens=12)
    queues = [engine.generate_ids(p, params) for p in PROMPTS]  # one batch
    streams = [_drain(q) for q in queues]
    for prompt, stream in zip(PROMPTS, streams):
        assert stream == reference_greedy(engine, prompt, 12)
    assert engine.stats()["prefill_chunks"] >= 3  # the 41-token prompt ran chunked


def _settled(engine, timeout=60.0):
    """Stats once the dispatch thread has released every finished slot
    (a stream's end reaches its consumer just before its release)."""
    deadline = time.time() + timeout
    while engine.stats()["pages_in_use"] and time.time() < deadline:
        time.sleep(0.01)
    return engine.stats()


def test_pages_return_to_the_allocator(engine):
    params = SamplingParams(temperature=0.0, max_tokens=9)
    for q in [engine.generate_ids(p, params) for p in PROMPTS * 2]:
        _drain(q)
    stats = _settled(engine)
    assert stats["pages_in_use"] == 0
    assert stats["pages_free"] == stats["pages_capacity"]
    assert stats["page_allocs"] == stats["page_frees"] > 0


def test_sampled_streams_depend_only_on_seed_and_position(engine):
    params = SamplingParams(temperature=0.9, top_p=0.8, max_tokens=10, seed=11)
    alone = list(engine.iter_ids(PROMPTS[0], params, timeout=120))
    queues = [engine.generate_ids(p, params) for p in (PROMPTS[2], PROMPTS[0], PROMPTS[1])]
    batched = [_drain(q) for q in queues][1]
    assert alone == batched
    other = list(engine.iter_ids(PROMPTS[0], SamplingParams(
        temperature=0.9, top_p=0.8, max_tokens=10, seed=12), timeout=120))
    assert other != alone


def test_abort_releases_the_slot(engine):
    params = SamplingParams(temperature=0.0, max_tokens=100)
    gen = engine.iter_ids(PROMPTS[1], params, timeout=120)
    first = [next(gen), next(gen)]
    gen.close()  # consumer gone: abort
    assert len(first) == 2
    # the engine keeps serving and ends with every page free
    assert len(list(engine.iter_ids(PROMPTS[0], SamplingParams(temperature=0.0, max_tokens=3), timeout=120))) <= 3
    assert _settled(engine)["pages_in_use"] == 0


def test_stream_text_and_chat(engine):
    text = "".join(engine.stream_text(engine.tokenizer.encode("hi", add_bos=True),
                                      SamplingParams(temperature=0.0, max_tokens=8)))
    assert isinstance(text, str)
    chat = "".join(engine.chat([("user", "hello")], SamplingParams(temperature=0.0, max_tokens=8)))
    assert isinstance(chat, str)


def test_over_long_prompts_keep_their_tail(engine):
    prompt = list(range(200))  # over max_seq_len 128
    req = engine.submit(prompt, SamplingParams(temperature=0.0, max_tokens=4))
    assert req.prompt_ids == prompt[-(128 - 1 - 4):]
    assert len(_drain(req.out_queue)) <= 4


def test_concurrent_consumers(engine):
    results = {}

    def run(i):
        results[i] = list(engine.iter_ids(PROMPTS[i % 3], SamplingParams(temperature=0.0, max_tokens=6), timeout=120))

    threads = [threading.Thread(target=run, args=(i,), name=f"consumer-{i}", daemon=True) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    for i in range(6):
        assert results[i] == results[i % 3]


def test_engine_refuses_to_start_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(EngineConfig(**CONFIG))


@pytest.mark.parametrize(
    "override",
    [dict(kv_cache_dtype="int8"), dict(kv_cache_dtype="int4"), dict(quantization="w8a8"),
     dict(page_size=12), dict(prefill_chunk=20), dict(dtype="float16")],
)
def test_config_refuses_what_the_slice_does_not_serve(override):
    with pytest.raises(ValueError):
        EngineConfig(**dict(CONFIG, **override)).validate()


def test_page_allocator_never_hands_out_the_scratch_page():
    alloc = kv_pages.PageAllocator(5, 8)
    pages = alloc.alloc(4)
    assert sorted(pages) == [1, 2, 3, 4] and kv_pages.SCRATCH_PAGE not in pages
    assert alloc.alloc(1) is None
    assert alloc.release(pages[:3]) == 3
    assert alloc.alloc(2) == [3, 2]  # freed pages are reused, most recent first
    assert alloc.release([2, 3, 4]) == 3
    assert alloc.free_pages() == 4
    with pytest.raises(ValueError):
        alloc.release([1])


def test_page_sizing_rules():
    assert kv_pages.pages_for_tokens(0, 8) == 0 and kv_pages.pages_for_tokens(9, 8) == 2
    assert kv_pages.pages_needed(10, 20, 8, 128, 5) == 5
    assert kv_pages.pages_needed(100, 100, 8, 128, 5) == 16  # capped at capacity
    cfg = EngineConfig(**CONFIG)
    assert kv_pages.pool_pages(cfg, 128) == 1 + 3 * 16
    with pytest.raises(ValueError):
        kv_pages.validate_runtime(8, 100, 64)


def test_greedy_sampling_matches_jax():
    logits = np.random.default_rng(0).standard_normal((4, 512)).astype(np.float32)
    zeros = np.zeros(4, np.float32)
    ref = jsampling.sample_tokens(jnp.asarray(logits), jnp.zeros((4, 2), jnp.uint32), zeros, zeros)
    out = sampling.sample_tokens(torch.from_numpy(logits), torch.zeros(4), torch.zeros(4))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_nucleus_sampling():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((1, 512)).astype(np.float32) * 3)
    temps, greedy = torch.tensor([1.0]), int(torch.argmax(logits))
    # a tiny top_p keeps only the top token
    for pos in range(5):
        noise = sampling.sample_noise([7], [pos])
        assert int(sampling.sample_tokens(logits, temps, torch.tensor([1e-6]), noise)) == greedy
    # top_p = 1 draws by the softmax over the top 64: the top token's
    # frequency over 4000 keyed draws matches its probability (seeded, so
    # deterministic; 4 sigma of the binomial spread)
    draws = torch.cat([
        sampling.sample_tokens(
            logits.expand(100, 512), temps.expand(100), torch.ones(100),
            sampling.sample_noise([3] * 100, range(i * 100, i * 100 + 100)),
        ) for i in range(40)
    ])
    top64 = torch.topk(logits[0], 64).values
    p = float(torch.softmax(top64, 0)[0])
    freq = float((draws == greedy).float().mean())
    assert abs(freq - p) < 4 * (p * (1 - p) / 4000) ** 0.5
    # noise is a pure function of (seed, position)
    assert torch.equal(sampling.sample_noise([5, 6], [9, 9]), sampling.sample_noise([5, 6], [9, 9]))
    assert not torch.equal(sampling.sample_noise([5], [9]), sampling.sample_noise([5], [10]))
    assert not torch.equal(sampling.sample_noise([5], [9]), sampling.sample_noise([6], [9]))
