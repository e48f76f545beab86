"""The port's serving engine on the CPU (every kernel wrapper runs its plain
version): greedy streams equal a model-level greedy loop over the same
weights, long prompts take the chunked path, pages return to the
allocator, sampling is keyed by (seed, position) with the JAX package's
keys, the quantized recipes (w8a8 + int8 KV, int8 + int4 KV) serve, and
the engine refuses to start without a card unless asked for the CPU. Plus the pieces it is
built from: the page allocator, the config checks and the sampler, and the
admission surface against the JAX engine's (``max_queued_requests``,
``prefill_wave_tokens``, the validation of the pipelined decode's fields).
The pipelined decode itself: tests/test_torch_engine_runahead.py."""
import collections
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.engine import llm_engine as jengine
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


def reference_stream(eng, prompt, max_tokens, choose=None):
    """Prefill (monolithic, or chunk by chunk past prefill_chunk, as the
    engine routes it) + one decode step at a time, straight through the
    model functions with the engine's pool dtype and quantization,
    stopping where the engine stops. ``choose(logits, key_position)``
    picks each token (greedy argmax by default)."""
    cfg, params, qk = eng.model_config, eng.params, eng._quant_kernel
    pmax = eng.max_seq_len // PAGE
    pool = llama.init_kv_pool(
        cfg, 1 + pmax, PAGE, torch.float32, quantized=eng._kv_quant, packed=eng._kv_packed
    )
    tables = torch.arange(1, 1 + pmax, dtype=torch.int32)[None]
    C = eng.engine_config.prefill_chunk
    if len(prompt) <= C:
        logits, kvs = llama.prefill_layers(
            params, cfg, torch.tensor([prompt]), torch.tensor([len(prompt)]), use_flash=False,
            quant_kernel=qk,
        )
        llama.write_prefill_pages(pool, kvs, tables, PAGE)
    else:
        for k in range(-(-len(prompt) // C)):
            seg = prompt[k * C:(k + 1) * C]
            last_h, _ = llama.extend_layers_paged(
                params, cfg, torch.tensor([seg + [0] * (C - len(seg))]), torch.tensor([k * C]),
                torch.tensor([len(seg)]), torch.tensor([0]), tables, pool,
                eng._attention_window(min((k + 1) * C, eng.max_seq_len)), PAGE, quant_kernel=qk,
            )
        logits = llama._head(params, last_h[:, None, :], cfg, qk)[:, 0, :]
    stops = set(eng.tokenizer.stop_ids())
    if choose is None:
        choose = lambda lg, key_pos: int(torch.argmax(lg[0, : eng._sample_vocab]))  # noqa: E731
    out, pos = [], len(prompt)
    key_pos = pos  # the first token is keyed at the prompt length
    while True:
        tok = choose(logits, key_pos)
        if tok in stops:
            return out
        out.append(tok)
        if len(out) >= max_tokens or pos >= eng.max_seq_len - 1:
            return out
        logits, _ = llama.decode_layers_paged(
            params, cfg, torch.tensor([tok]), torch.tensor([pos]), torch.tensor([True]),
            tables, pool, window=eng.max_seq_len, page_size=PAGE, quant_kernel=qk,
            page_kernel=False,
        )
        key_pos = min(pos + 1, eng.max_seq_len - 1)  # the token made from input position p
        pos += 1


def reference_greedy(eng, prompt, max_tokens):
    return reference_stream(eng, prompt, max_tokens)


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


def entry_pages(engine) -> int:
    """Pool pages the prefix cache's entries hold (the engine's default
    ``prefix_cache_enable='auto'`` keeps each chunked prompt's prefix)."""
    if engine._prefix is None:
        return 0
    with engine._prefix._lock:
        return len({p for e in engine._prefix._entries for p in e.pages or ()})


def _settled(engine, timeout=60.0):
    """Stats once the dispatch thread has released every finished slot
    (a stream's end reaches its consumer just before its release): every
    page in use is then one a prefix-cache entry holds."""
    deadline = time.time() + timeout
    while engine.stats()["pages_in_use"] != entry_pages(engine) and time.time() < deadline:
        time.sleep(0.01)
    return engine.stats()


@pytest.mark.parametrize("top_p", [0.8, 1.0], ids=["nucleus", "full-vocab"])
def test_seeded_streams_draw_with_the_jax_keys(engine, top_p):
    """A seeded sampled stream equals the model-level loop drawing each
    token with the JAX package's own sampler and keys:
    sample_tokens(sample_keys(PRNGKey(1234), seed, position))."""
    seed, temp = 11, 0.9
    draw = jax.jit(lambda lg, pos: jsampling.sample_tokens(
        lg, jsampling.sample_keys(jax.random.PRNGKey(1234), jnp.asarray([seed]), pos),
        jnp.asarray([temp]), jnp.asarray([top_p]),
    ))

    def choose(logits, key_pos):
        lg = jnp.asarray(logits[:, : engine._sample_vocab].numpy())
        return int(draw(lg, jnp.asarray([key_pos], jnp.int32))[0])

    params = SamplingParams(temperature=temp, top_p=top_p, max_tokens=12, seed=seed)
    for prompt in PROMPTS:
        assert list(engine.iter_ids(prompt, params, timeout=120)) == reference_stream(
            engine, prompt, 12, choose
        )


@pytest.mark.parametrize(
    "quantization,kv_cache_dtype", [("w8a8", "int8"), ("int8", "int4")], ids=["w8a8-int8", "int8-int4"]
)
def test_quantized_configs_stream_like_the_model_level_loop(quantization, kv_cache_dtype):
    eng = LLMEngine(EngineConfig(**dict(
        CONFIG, quantization=quantization, kv_cache_dtype=kv_cache_dtype
    )), device="cpu")
    try:
        pool = eng._cache[0]
        assert pool["k"].dtype == (torch.int8 if kv_cache_dtype == "int8" else torch.uint8)
        assert pool["ks"].dtype == torch.float32
        assert isinstance(eng.params["layers"][0]["wqkv"], dict)  # int8 packs
        params = SamplingParams(temperature=0.0, max_tokens=10)
        queues = [eng.generate_ids(p, params) for p in PROMPTS]  # one batch
        for prompt, q in zip(PROMPTS, queues):
            assert _drain(q) == reference_greedy(eng, prompt, 10)
        assert eng.stats()["prefill_chunks"] >= 3  # the 41-token prompt ran chunked
    finally:
        assert eng.shutdown()


def test_pages_return_to_the_allocator(engine):
    params = SamplingParams(temperature=0.0, max_tokens=9)
    for q in [engine.generate_ids(p, params) for p in PROMPTS * 2]:
        _drain(q)
    stats = _settled(engine)
    held = entry_pages(engine)
    assert held > 0  # the 41-token prompt's two chunks stay cached
    assert stats["pages_in_use"] == held
    assert stats["pages_free"] == stats["pages_capacity"] - held
    assert stats["page_allocs"] == stats["page_frees"] + held
    assert stats["page_frees"] > 0


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
    assert _settled(engine)["pages_in_use"] == entry_pages(engine)


def _jax_abort_answer(state):
    """What the JAX engine's ``abort(rid)`` returns for a request in
    ``state``: its own method run on the bookkeeping it reads (the pending
    deque, the slot map, the scheduler's lookup), holding one request."""
    stub = types.SimpleNamespace(
        _lock=threading.Condition(), _pending=collections.deque(), _slot_req={},
        scheduler=types.SimpleNamespace(find_rid=lambda rid: None),
    )
    req = jengine._Request(rid=7, prompt_ids=[1], params=jengine.SamplingParams())
    if state == "pending":
        stub._pending.append(req)
    elif state == "slotted":
        req.slot = 0
        stub._slot_req[0] = req
    elif state == "finished":
        req.finished = True  # the reader thread ended it; no queue holds it
    return jengine.LLMEngine.abort(stub, 8 if state == "unknown" else 7)


@pytest.mark.parametrize("state", ["pending", "slotted", "unknown", "finished"])
def test_abort_by_rid_answers_as_the_jax_engine(engine, state):
    """``abort(rid)`` finds a pending or slotted request by its rid and
    ends its stream; an unknown or finished rid answers False. Each answer
    is the JAX engine's for the same state."""
    greedy = SamplingParams(temperature=0.0, max_tokens=100)
    if state == "pending":
        with engine._lock:  # the dispatch loop cannot admit it meanwhile
            req = engine.submit(PROMPTS[0], greedy)
            got = engine.abort(req.rid)
        assert _drain(req.out_queue) == []
    elif state == "slotted":
        req = engine.submit(PROMPTS[1], greedy)
        assert req.out_queue.get(timeout=120) is not None  # decoding in its slot
        got = engine.abort(req.rid)
        assert len(_drain(req.out_queue)) < 99  # released before max_tokens
    elif state == "unknown":
        got = engine.abort(10**9)
    else:
        req = engine.submit(PROMPTS[0], SamplingParams(temperature=0.0, max_tokens=2))
        _drain(req.out_queue)
        _settled(engine)
        got = engine.abort(req.rid)
    assert got is _jax_abort_answer(state)
    assert got is (state in ("pending", "slotted"))
    assert _settled(engine)["pages_in_use"] == entry_pages(engine)


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
    [dict(kv_cache_dtype="fp8"), dict(kv_cache_dtype="int2"), dict(quantization="int4"),
     dict(page_size=12, kv_layout="paged"), dict(prefill_chunk=20, kv_layout="paged"),
     dict(dtype="float16")],
)
def test_config_refuses_what_the_slice_does_not_serve(override):
    """A page geometry that does not tile is refused under an explicit
    kv_layout='paged'; under 'auto' the engine serves it on the fixed
    layout (tests/test_torch_engine_fixed.py)."""
    with pytest.raises(ValueError):
        EngineConfig(**dict(CONFIG, **override)).validate()


@pytest.mark.parametrize(
    "override",
    [dict(kv_cache_dtype="int8"), dict(kv_cache_dtype="int4"), dict(quantization="w8a8"),
     dict(quantization="int8")],
)
def test_config_accepts_the_quantized_recipes(override):
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
        keys = sampling.sample_keys(torch.tensor([7]), torch.tensor([pos]))
        assert int(sampling.sample_tokens(logits, temps, torch.tensor([1e-6]), keys)) == greedy
    # top_p = 1 draws from the softmax over the whole vocabulary: the top
    # token's frequency over 4000 keyed draws matches its probability
    # (seeded, so deterministic; 4 sigma of the binomial spread)
    n = 4000
    draws = sampling.sample_tokens(
        logits.expand(n, 512), temps.expand(n), torch.ones(n),
        sampling.sample_keys(torch.tensor(3), torch.arange(n)),
    )
    p = float(torch.softmax(logits[0], 0)[greedy])
    freq = float((draws == greedy).float().mean())
    assert abs(freq - p) < 4 * (p * (1 - p) / n) ** 0.5
    # keys are a pure function of (seed, position)
    a = sampling.sample_keys(torch.tensor([5, 6]), torch.tensor([9, 9]))
    b = sampling.sample_keys(torch.tensor([5, 6]), torch.tensor([9, 9]))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0][0], a[0][1])
    c = sampling.sample_keys(torch.tensor([5]), torch.tensor([10]))
    assert not (torch.equal(a[0][:1], c[0]) and torch.equal(a[1][:1], c[1]))


# --------------------------------------------------------------------- #
# the admission surface: max_queued_requests, prefill_wave_tokens and the
# validation of the pipelined decode's fields, held against the JAX engine


class _AdmitGate:
    """Holds the dispatch loop before its next admission until ``open()``,
    so submitted requests stay pending."""

    def __init__(self, eng):
        self.event = threading.Event()
        admit = eng._admit

        def gated():
            assert self.event.wait(60)
            admit()

        eng._admit = gated

    def open(self):
        self.event.set()


def test_submit_raises_engine_overloaded_at_the_cap(monkeypatch):
    from generativeaiexamples_tpu_torch.engine import llm_engine

    eng = LLMEngine(EngineConfig(**dict(CONFIG, max_queued_requests=3)), device="cpu")
    try:
        gate = _AdmitGate(eng)
        greedy = SamplingParams(temperature=0.0, max_tokens=4)
        queues = [eng.generate_ids(p, greedy) for p in PROMPTS]
        with pytest.raises(llm_engine.EngineOverloaded, match=r"queue full \(3/3 pending\)") as err:
            eng.submit(PROMPTS[0], greedy)
        assert err.value.retry_after == 1.0
        assert eng.queue_depth() == 3
        monkeypatch.setattr(llm_engine, "_ENGINE", eng)
        assert llm_engine.live_queue_depth() == 3
        gate.open()
        for prompt, q in zip(PROMPTS, queues):
            assert _drain(q) == reference_greedy(eng, prompt, 4)
        assert eng.queue_depth() == 0
        assert _drain(eng.generate_ids(PROMPTS[0], greedy)) == reference_greedy(eng, PROMPTS[0], 4)
    finally:
        assert eng.shutdown()
    monkeypatch.setattr(llm_engine, "_ENGINE", None)
    assert llm_engine.live_queue_depth() is None


def _jax_validation_error(field, value):
    """The JAX package's message for one bad engine value: its engine
    constructor's resilience checks, or its config validator (whose
    messages carry the section prefix ``engine.``)."""
    from generativeaiexamples_tpu.config.schema import AppConfig
    from generativeaiexamples_tpu.config.validate import validate_config

    app = AppConfig.from_dict({"engine": {"max_batch_size": 3, field: value}})
    try:
        if field in ("decode_runahead", "prefill_wave_tokens"):
            validate_config(app)
        else:
            jengine._validate_resilience_knobs(app.engine)
    except ValueError as exc:
        return str(exc).removeprefix("engine.")
    return None


@pytest.mark.parametrize("field,value", [
    ("decode_runahead", 0), ("prefill_wave_tokens", 0), ("max_queued_requests", -1),
    ("max_queued_requests", 2), ("watchdog_stall_s", -1.0),
])
def test_validation_errors_match_the_jax_engine(field, value):
    expected = _jax_validation_error(field, value)
    assert expected is not None
    with pytest.raises(ValueError) as err:
        EngineConfig(**dict(CONFIG, **{field: value})).validate()
    assert str(err.value) == expected


@pytest.mark.parametrize("field,value", [
    ("decode_runahead", 1), ("prefill_wave_tokens", 1), ("max_queued_requests", 0),
    ("max_queued_requests", 3), ("watchdog_stall_s", 0.0),
])
def test_validation_accepts_what_the_jax_engine_accepts(field, value):
    assert _jax_validation_error(field, value) is None
    EngineConfig(**dict(CONFIG, **{field: value})).validate()


@pytest.mark.parametrize("num_slots,budget,bucket", [
    (8, 16384, 512), (8, 16384, 8192), (64, 16384, 512), (3, 16, 16), (3, 40, 16),
    (3, 5, 16), (1, 16384, 128), (16, 4096, 300), (2, 0, 16),
])
def test_max_wave_rows_matches_the_jax_formula(num_slots, budget, bucket):
    stub = types.SimpleNamespace(
        num_slots=num_slots, engine_config=types.SimpleNamespace(prefill_wave_tokens=budget)
    )
    assert LLMEngine._max_wave_rows(stub, bucket) == jengine.LLMEngine._max_wave_rows(stub, bucket)


def test_prefill_wave_tokens_caps_each_wave():
    """prefill_wave_tokens 16 at prefill_chunk 16 admits one row a wave:
    three requests submitted together take three waves, and stream as
    one wave would."""
    eng = LLMEngine(EngineConfig(**dict(CONFIG, prefill_wave_tokens=16)), device="cpu")
    try:
        gate = _AdmitGate(eng)
        greedy = SamplingParams(temperature=0.0, max_tokens=6)
        queues = [eng.generate_ids(p, greedy) for p in PROMPTS]
        gate.open()
        for prompt, q in zip(PROMPTS, queues):
            assert _drain(q) == reference_greedy(eng, prompt, 6)
        assert eng.stats()["prefill_waves"] == 3
    finally:
        assert eng.shutdown()


def _jax_stub():
    """The bookkeeping the JAX engine's ``is_decoding`` and
    ``hold_admissions`` read, to run its own methods on."""
    return types.SimpleNamespace(_lock=threading.Condition(), _slot_req={}, _paused=False)


def test_is_decoding_follows_the_slots_as_in_jax(engine):
    stub = _jax_stub()
    assert jengine.LLMEngine.is_decoding(stub) is False
    stub._slot_req[0] = object()
    assert jengine.LLMEngine.is_decoding(stub) is True
    _settled(engine)
    assert engine.is_decoding() is False
    gen = engine.iter_ids(PROMPTS[1], SamplingParams(temperature=0.0, max_tokens=60), timeout=120)
    next(gen)
    assert engine.is_decoding() is True  # a slot is held while the stream runs
    rest = list(gen)
    assert len(rest) <= 59
    deadline = time.time() + 30
    while engine.is_decoding() and time.time() < deadline:
        time.sleep(0.005)
    assert engine.is_decoding() is False


def test_hold_admissions_admits_one_wave(engine):
    """Requests submitted under ``hold_admissions`` stay pending until it
    exits, then go in one prefill wave (the JAX method sets the same flag)."""
    stub = _jax_stub()
    with jengine.LLMEngine.hold_admissions(stub):
        assert stub._paused is True
    assert stub._paused is False
    _settled(engine)
    waves = engine.stats()["prefill_waves"]
    params = SamplingParams(temperature=0.0, max_tokens=4)
    with engine.hold_admissions():
        assert engine._paused is True
        queues = [engine.generate_ids(p, params) for p in ([256, 5, 6], [256, 7], [256, 8, 9, 10])]
        time.sleep(0.2)
        assert engine.queue_depth() == 3 and not engine.is_decoding()
        assert not engine.scheduler.has_work()  # the loop sleeps instead of spinning
    streams = [_drain(q) for q in queues]
    assert all(0 < len(s) <= 4 for s in streams)
    assert engine.stats()["prefill_waves"] == waves + 1
    assert engine._paused is False
