"""Speculative decoding in the port against the JAX package.

Model level (tier 1), on the debug preset (2 layers), the same weights and
inputs on both sides:
- ``verify_layers_paged`` over a bf16 (here f32), int8 and int4 pool, with
  the gathered read and with the page kernel's read (JAX's Pallas kernel
  in interpret mode, the port's plain version): two verify rounds of K+1
  = 5 query rows, a dead row, a row whose chunk crosses a page edge, a
  row with fewer valid rows than the chunk, and a second round from a
  frontier below the first's rows (rejected rows overwritten);
- ``verify_layers`` over the fixed f32 and int8 caches.
Logits of the valid positions, and for float32 weights the pools after
the rounds, are compared. Tolerances: float32 weights, the gathered or
fixed read: f32 summation order (ATOL_F32 = 1e-5; the quantized pools'
integers within one step, scales within an ulp). bf16 weights: the two
packages' bf16 products round at different points, up to 4 bf16 ulps of
an O(1) logit after two layers (ATOL_BF16 = 0.03125; 0.0234 measured on
the int8 fixed cache). The page kernel's read: JAX's Pallas kernel in
interpret mode reads the pool in bf16 and rounds probabilities (times V
scales) to bf16 where the port's plain version stays f32 (ATOL_KERNEL_READ
= 0.125; 0.10 measured on the int4 pool with bf16 weights).

Engine level, on the debug preset in float32 (tier 1; ``slow`` marks the
cases that build JAX engines): with ``spec_decode_enable`` on, greedy and
seeded streams are token-identical to spec off (lookup, the draft model
and combined, pipeline on and off, both layouts, ``decode_runahead`` 1
and 4, int8 and int4 pools, the prefix cache warm, per-request opt-out,
a budget smaller than the draft); the verify's contract (the packed
result, the sampling keys on the position grid, the accepted run);
``set_spec_decode`` and ``set_spec_proposer``; the build check that
refuses a verify the page kernel cannot serve; and, on the JAX engine's
own weights, the port's spec streams equal the JAX spec engine's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine.llm_engine import LLMEngine as JaxEngine
from generativeaiexamples_tpu.engine.llm_engine import SamplingParams as JaxParams
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import llm_engine
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.models import sampling as tsampling
from generativeaiexamples_tpu_torch.models.convert import params_from_jax
from generativeaiexamples_tpu_torch.ops import page_attention

CFG_J = jl.PRESETS["debug"]
CFG_T = tl.PRESETS["debug"]
PAGE = 8
PMAX = CFG_J.max_seq_len // PAGE
POOL = 1 + 3 * PMAX
K = 4
ATOL_F32 = 1e-5
ATOL_BF16 = 0.03125
ATOL_KERNEL_READ = 0.125
# prompts of rows 0 and 1 (row 2 is dead); row 1's first verify chunk
# crosses the page edge at 24
PROMPT_LENS = [11, 22]
# (offsets, valid) of the two rounds: round 2 starts row 0 two rows past
# its first frontier (2 of its 4 drafts accepted, below rows round 1
# wrote) and row 1 at its last valid row + 1
ROUNDS = [([11, 22, 0], [5, 3, 0]), ([13, 25, 0], [5, 5, 0])]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=["f32", "bf16"])
def weights(request):
    """(JAX layered params, JAX quant mode, port params, port quant mode,
    dtype pair, name)."""
    dt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[request.param]
    stacked = jl.init_params(CFG_J, jax.random.PRNGKey(0), dt[0])
    port = params_from_jax(stacked)
    return (jl.consume_split_params_layers(stacked), None, port, None, dt, request.param)


def _tables():
    tables = np.zeros((3, PMAX), np.int32)
    tables[0] = 1 + np.arange(PMAX)
    tables[1] = 1 + PMAX + np.arange(PMAX)
    return tables


def _tokens(rng, shape):
    return rng.integers(0, CFG_J.vocab_size, shape).astype(np.int32)


def _tol(name, kernel):
    if kernel:
        return ATOL_KERNEL_READ
    return ATOL_F32 if name == "f32" else ATOL_BF16


@pytest.mark.parametrize("page_kernel", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "int4"])
def test_verify_layers_paged_equals_jax(weights, kv_dtype, page_kernel):
    jparams, jqk, port, tqk, (jdt, tdt), name = weights
    quantized, packed = kv_dtype != "bfloat16", kv_dtype == "int4"
    rng = np.random.default_rng(1)
    tables = _tables()
    jpool = jl.init_kv_pool(CFG_J, POOL, PAGE, jdt, quantized=quantized, packed=packed)
    tpool = tl.init_kv_pool(CFG_T, POOL, PAGE, tdt, quantized=quantized, packed=packed)
    slots = np.arange(3, dtype=np.int32)
    # the prompts, one chunk of 24 with each row's valid length
    prompt = _tokens(rng, (3, 24))
    valid = np.asarray(PROMPT_LENS + [0], np.int32)
    zeros = np.zeros(3, np.int32)
    _, jpool = jl.extend_layers_paged(
        jparams, CFG_J, jnp.asarray(prompt), jnp.asarray(zeros), jnp.asarray(valid),
        jnp.asarray(slots), jnp.asarray(tables), jpool, 32, PAGE, quant_kernel=jqk)
    tl.extend_layers_paged(
        port, CFG_T, torch.from_numpy(prompt).long(), torch.from_numpy(zeros).long(),
        torch.from_numpy(valid).long(), torch.from_numpy(slots).long(),
        torch.from_numpy(tables), tpool, 32, PAGE, quant_kernel=tqk)
    atol = _tol(name, page_kernel)
    for offsets, valid in ROUNDS:
        chunk = _tokens(rng, (3, K + 1))
        offsets, valid = np.asarray(offsets, np.int32), np.asarray(valid, np.int32)
        ref, jpool = jl.verify_layers_paged(
            jparams, CFG_J, jnp.asarray(chunk), jnp.asarray(offsets), jnp.asarray(valid),
            jnp.asarray(slots), jnp.asarray(tables), jpool, 64, PAGE, quant_kernel=jqk,
            page_kernel="interpret" if page_kernel else None)
        out, pool = tl.verify_layers_paged(
            port, CFG_T, torch.from_numpy(chunk).long(), torch.from_numpy(offsets).long(),
            torch.from_numpy(valid).long(), torch.from_numpy(slots).long(),
            torch.from_numpy(tables), tpool, 64, PAGE, quant_kernel=tqk, page_kernel=page_kernel)
        assert pool is tpool and tuple(out.shape) == (3, K + 1, CFG_T.vocab_size)
        assert bool(torch.isfinite(out).all())
        for row in range(2):
            n = int(valid[row])
            np.testing.assert_allclose(_np(out)[row, :n], _np(ref)[row, :n], rtol=0, atol=atol)
    if name == "f32" and not page_kernel:
        _assert_pools(tpool, jpool, first=1)  # the scratch page aside


def _assert_pools(tcaches, jcaches, first=0):
    """Scales within an ulp, integers within one quantization step (a last
    ulp of a K/V row can move its rounding), f32 rows within ATOL_F32."""
    for tc, jc in zip(tcaches, jcaches):
        for key in tc:
            mine, ref = tc[key][first:], jnp.asarray(jc[key])[first:]
            if key in ("ks", "vs"):
                np.testing.assert_allclose(_np(mine), _np(ref), rtol=1e-5, atol=0, err_msg=key)
            elif mine.dtype in (torch.int8, torch.uint8):
                if mine.dtype == torch.uint8:
                    mine, ref = tl.unpack_int4(mine), jl.unpack_int4(ref)
                diff = np.abs(mine.numpy().astype(np.int32) - np.asarray(ref).astype(np.int32))
                assert diff.max() <= 1, key
            else:
                np.testing.assert_allclose(_np(mine), _np(ref), rtol=0, atol=ATOL_F32, err_msg=key)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_verify_layers_fixed_equals_jax(weights, quantized):
    jparams, jqk, port, tqk, (jdt, tdt), name = weights
    rng = np.random.default_rng(2)
    S, B = CFG_J.max_seq_len, 3
    jc = jl.init_kv_cache_layers(CFG_J, B, S, jdt, quantized=quantized)
    tc = tl.init_kv_cache_layers(CFG_T, B, S, tdt, quantized=quantized)
    slots = np.arange(B, dtype=np.int32)
    prompt = _tokens(rng, (3, 24))
    valid = np.asarray(PROMPT_LENS + [0], np.int32)
    zeros = np.zeros(3, np.int32)
    _, jc = jl.extend_layers(jparams, CFG_J, jnp.asarray(prompt), jnp.asarray(zeros),
                             jnp.asarray(valid), jnp.asarray(slots), jc, 32, quant_kernel=jqk)
    tl.extend_layers(port, CFG_T, torch.from_numpy(prompt).long(), torch.from_numpy(zeros).long(),
                     torch.from_numpy(valid).long(), torch.from_numpy(slots).long(), tc, 32,
                     quant_kernel=tqk)
    atol = _tol(name, False)
    for offsets, valid in ROUNDS:
        chunk = _tokens(rng, (3, K + 1))
        offsets, valid = np.asarray(offsets, np.int32), np.asarray(valid, np.int32)
        ref, jc = jl.verify_layers(
            jparams, CFG_J, jnp.asarray(chunk), jnp.asarray(offsets), jnp.asarray(valid),
            jnp.asarray(slots), jc, 64, quant_kernel=jqk)
        out, caches = tl.verify_layers(
            port, CFG_T, torch.from_numpy(chunk).long(), torch.from_numpy(offsets).long(),
            torch.from_numpy(valid).long(), torch.from_numpy(slots).long(), tc, 64,
            quant_kernel=tqk)
        assert caches is tc and tuple(out.shape) == (3, K + 1, CFG_T.vocab_size)
        for row in range(2):
            n = int(valid[row])
            np.testing.assert_allclose(_np(out)[row, :n], _np(ref)[row, :n], rtol=0, atol=atol)
    if name == "f32":
        _assert_pools(tc, jc)


def test_spec_accept_contract():
    """The verify's acceptance: the outputs sampled at each position with
    the keys plain decode would use (``offsets + 1 + j``, clamped), the
    accepted run of drafts equal to the outputs, the bonus token at the
    run's end, dead rows untouched, and the packed ``[B, K+2]``."""
    rng = np.random.default_rng(3)
    B, V, max_pos = 4, 64, 40
    logits = torch.from_numpy(rng.standard_normal((B, K + 1, V)).astype(np.float32))
    greedy = logits.argmax(-1)
    draft = greedy[:, :K].clone()
    draft[1, 2] = (draft[1, 2] + 1) % V  # row 1 accepts 2
    draft[2, 0] = (draft[2, 0] + 1) % V  # row 2 accepts none
    draft_len = torch.tensor([4, 4, 4, 2])
    positions = torch.tensor([5, 9, 39, 0])
    live = torch.tensor([True, True, True, False])
    tokens = torch.tensor([1, 2, 3, 4])
    temps = torch.zeros(B)
    topps = torch.ones(B)
    seeds = torch.arange(B)
    offsets = torch.where(live, positions, 0)
    new_tok, new_pos, packed = llm_engine._spec_accept(
        logits, tokens, positions, offsets, temps, topps, seeds, draft, draft_len, live,
        max_pos=max_pos, vocab=V, sampled=False)
    accepted = packed[:, -1].tolist()
    assert accepted == [4, 2, 0, 2] and tuple(packed.shape) == (B, K + 2)
    assert torch.equal(packed[:, :-1], greedy)
    assert new_tok[:3].tolist() == [int(greedy[r, a]) for r, a in zip(range(3), accepted)]
    assert new_tok[3] == 4 and new_pos[3] == 0  # the dead row keeps its state
    assert new_pos[:3].tolist() == [10, 12, max_pos]  # clamped at max_pos
    # sampled rows: position j's token is the plain decode draw keyed at
    # offsets + 1 + j
    temps = torch.full((B,), 0.8)
    topps = torch.full((B,), 0.9)
    _, _, packed = llm_engine._spec_accept(
        logits, tokens, positions, offsets, temps, topps, seeds, draft, draft_len, live,
        max_pos=max_pos, vocab=V, sampled=True)
    for j in range(K + 1):
        keys = tsampling.sample_keys(seeds, torch.clamp(offsets + 1 + j, max=max_pos))
        want = tsampling.sample_tokens(logits[:, j], temps, topps, keys)
        assert torch.equal(packed[:, j], want), j


# --------------------------------------------------------------------- #
# engine level

TINY = dict(model_config_name="debug", max_batch_size=4, max_seq_len=128, prefill_chunk=16,
            dtype="float32", page_size=16)
COPY_PROMPT = [3 + 10 * i for i in range(16)]
PLAIN_PROMPT = [(i * 7) % 250 + 1 for i in range(24)]
LONG_PROMPT = [256] + [(5 * i) % 250 for i in range(37)]  # chunked prefill


def _legs():
    return [
        (COPY_PROMPT, SamplingParams(temperature=0.0, max_tokens=64)),
        (PLAIN_PROMPT, SamplingParams(temperature=0.0, max_tokens=40)),
        (LONG_PROMPT, SamplingParams(temperature=0.0, max_tokens=40)),
        (COPY_PROMPT, SamplingParams(temperature=0.8, top_p=0.9, max_tokens=32, seed=1234)),
        (PLAIN_PROMPT, SamplingParams(temperature=0.0, max_tokens=24, spec_decode=False)),
        (COPY_PROMPT, SamplingParams(temperature=0.0, max_tokens=3)),  # budget below K
    ]


def _streams(engine, together=False):
    if together:
        with engine.hold_admissions():
            reqs = [engine.submit(p, sp) for p, sp in _legs()]
        out = []
        for req in reqs:
            toks = []
            while (t := req.out_queue.get(timeout=120)) is not None:
                toks.append(t)
            out.append(toks)
        return out
    return [list(engine.iter_ids(p, sp, timeout=120)) for p, sp in _legs()]


_REF = {}


def _reference(**kw):
    """Spec-off streams of a config (cached per config)."""
    key = tuple(sorted(kw.items()))
    if key not in _REF:
        engine = LLMEngine(EngineConfig(**dict(TINY, **kw)), device="cpu")
        try:
            _REF[key] = (_streams(engine), _streams(engine, together=True))
        finally:
            engine.shutdown()
    return _REF[key]


DRAFT = dict(spec_draft_model="debug-draft")
CASES = {
    "paged-lookup-pipelined": dict(kv_layout="paged", decode_block=4),
    "paged-lookup-sync": dict(kv_layout="paged", decode_block=4, spec_pipeline_enable="off"),
    "fixed-lookup-pipelined": dict(kv_layout="fixed", decode_block=1),
    "fixed-lookup-sync-runahead1": dict(kv_layout="fixed", decode_block=2, decode_runahead=1,
                                        spec_pipeline_enable="off"),
    "paged-int8kv-runahead1": dict(kv_layout="paged", decode_block=2, kv_cache_dtype="int8",
                                   decode_runahead=1),
    "paged-int4kv": dict(kv_layout="paged", decode_block=4, kv_cache_dtype="int4"),
    "fixed-int8kv": dict(kv_layout="fixed", decode_block=4, kv_cache_dtype="int8"),
    "paged-adaptive-k": dict(kv_layout="paged", decode_block=4, spec_adaptive_k="on"),
    "paged-k2": dict(kv_layout="paged", decode_block=4, spec_draft_len=2),
    "paged-no-prefix-cache": dict(kv_layout="paged", decode_block=4, prefix_cache_enable="off"),
    "paged-draft-model": dict(kv_layout="paged", decode_block=4, spec_proposer="draft_model",
                              **DRAFT),
    "fixed-draft-model-int8": dict(kv_layout="fixed", decode_block=4, spec_proposer="draft_model",
                                   spec_draft_kv_dtype="int8", **DRAFT),
    "paged-combined": dict(kv_layout="paged", decode_block=4, spec_proposer="combined", **DRAFT),
    "fixed-draft-model-k3": dict(kv_layout="fixed", decode_block=4, spec_proposer="draft_model",
                                 spec_draft_model_len=3, **DRAFT),
    "paged-disagg": dict(kv_layout="paged", decode_block=4, scheduler_policy="disagg"),
    "paged-disagg-draft-model": dict(kv_layout="paged", decode_block=4,
                                     scheduler_policy="disagg", spec_proposer="draft_model",
                                     **DRAFT),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spec_streams_equal_spec_off(case):
    kw = CASES[case]
    off = {k: v for k, v in kw.items() if not k.startswith("spec_")}
    ref_alone, ref_together = _reference(**off)
    engine = LLMEngine(EngineConfig(**dict(TINY, spec_decode_enable="on", **kw)), device="cpu")
    try:
        assert engine._spec_enabled
        s0 = engine.stats()
        assert _streams(engine) == ref_alone
        assert _streams(engine, together=True) == ref_together
        s1 = engine.stats()
        assert s1["spec_verify_dispatches"] > s0["spec_verify_dispatches"]
        assert s1["spec_drafted_tokens"] > s0["spec_drafted_tokens"]
        if engine._draft is not None:
            assert s1["spec_draft_dispatches"] > s0["spec_draft_dispatches"]
        if kw.get("spec_pipeline_enable") == "off":
            assert s1["spec_pipeline_confirmed"] == s1["spec_pipeline_rollbacks"] == 0
        _settle(engine)
        assert not engine._spec_ctx  # every context went with its slot
        if engine._draft is not None:
            assert not engine._draft.tracker._fed
    finally:
        engine.shutdown()


def _settle(engine, timeout=30.0):
    import time

    deadline = time.time() + timeout
    while engine._slot_req and time.time() < deadline:
        time.sleep(0.01)
    assert not engine._slot_req


def test_copy_prompt_emits_more_than_one_token_a_verify():
    """Lookup on the copy-heavy prompt accepts drafts: fewer dispatches
    than tokens, and the acceptance counters move."""
    engine = LLMEngine(EngineConfig(**dict(TINY, decode_block=1, spec_decode_enable="on")),
                       device="cpu")
    try:
        s0 = engine.stats()
        out = list(engine.iter_ids(COPY_PROMPT, SamplingParams(temperature=0.0, max_tokens=96),
                                   timeout=120))
        s1 = engine.stats()
        dispatches = s1["decode_dispatches"] - s0["decode_dispatches"]
        assert len(out) == 96 and dispatches < len(out) - 1
        assert s1["spec_accepted_tokens"] > s0["spec_accepted_tokens"]
    finally:
        engine.shutdown()


def test_sampled_only_traffic_under_lookup_keeps_the_block_path():
    engine = LLMEngine(EngineConfig(**dict(TINY, decode_block=4, spec_decode_enable="on")),
                       device="cpu")
    try:
        list(engine.iter_ids(COPY_PROMPT, SamplingParams(temperature=0.8, max_tokens=16, seed=3),
                             timeout=60))
        st = engine.stats()
        assert st["spec_verify_dispatches"] == st["spec_block_dispatches"] == 0
        assert st["decode_dispatches"] > 0 and not engine._spec_ctx
    finally:
        engine.shutdown()


def test_runtime_toggles():
    """``set_spec_decode`` off restores the block path and drops every
    context; ``set_spec_proposer`` builds the draft model on first use
    and refuses a draft kind with no draft model configured."""
    ref = _reference(kv_layout="paged", decode_block=4)[0]
    engine = LLMEngine(EngineConfig(**dict(TINY, kv_layout="paged", decode_block=4,
                                           spec_decode_enable="on", **DRAFT)), device="cpu")
    try:
        assert engine._draft is None and engine._spec_proposer.kind == "lookup"
        assert engine.set_spec_proposer("draft_model") == "draft_model"
        assert engine._draft is not None
        assert _streams(engine) == ref
        assert engine.set_spec_proposer("combined") == "combined"
        assert _streams(engine) == ref
        with pytest.raises(ValueError, match="spec proposer must be one of"):
            engine.set_spec_proposer("oracle")
        assert engine.set_spec_decode(False) is False
        s0 = engine.stats()
        assert _streams(engine) == ref
        s1 = engine.stats()
        assert s1["spec_verify_dispatches"] == s0["spec_verify_dispatches"]
        assert engine.set_spec_decode(True) is True
    finally:
        engine.shutdown()
    plain = LLMEngine(EngineConfig(**dict(TINY, spec_decode_enable="on")), device="cpu")
    try:
        assert plain.set_spec_proposer("draft_model") is None
    finally:
        plain.shutdown()


def test_verify_geometry_gate():
    """The gate is ``supports_geometry`` at K+1 query rows: 200 drafts of
    32 heads exceed the kernel's row cap, 8 do not. A paged engine the
    kernel refuses still verifies on the CPU (the plain read), token for
    token."""
    cfg8b = tl.PRESETS["llama3-8b"]
    for k, ok in ((8, True), (15, True), (16, False), (200, False)):
        assert page_attention.supports_geometry(
            128, cfg8b.head_dim, cfg8b.num_heads, cfg8b.num_kv_heads, query_len=k + 1) is ok, k
    engine = LLMEngine(EngineConfig(**dict(TINY, kv_layout="paged", decode_block=4,
                                           spec_draft_len=200, spec_decode_enable="on")),
                       device="cpu")
    try:
        assert not engine._verify_kernel and engine._spec_available
        out = list(engine.iter_ids(COPY_PROMPT, SamplingParams(temperature=0.0, max_tokens=24),
                                   timeout=60))
        assert out == _reference(kv_layout="paged", decode_block=4)[0][0][:24]
    finally:
        engine.shutdown()


def test_check_kernels_refuses_a_spec_config_the_page_kernel_cannot_verify():
    engine = LLMEngine.__new__(LLMEngine)
    engine._spec_available, engine._spec_draft = False, 16
    engine._paged, engine._page_kernel = True, True
    cfg = EngineConfig(spec_decode_enable="on", spec_draft_len=16)
    with pytest.raises(ValueError, match="spec verify's 17 query rows x 32 heads"):
        engine._check_kernels(cfg, tl.PRESETS["llama3-8b"], torch.bfloat16)


def test_server_parses_spec_decode_as_jax_does():
    from generativeaiexamples_tpu.engine.server import ModelServer as JaxServer
    from generativeaiexamples_tpu_torch.engine.server import ModelServer

    mine = ModelServer(engine=object())
    for body in ({}, {"spec_decode": False}, {"spec_decode": True}, {"spec_decode": "false"},
                 {"spec_decode": "true"}, {"spec_decode": "on"}, {"spec_decode": 0},
                 {"spec_decode": "nope"}):
        assert mine.sampling(body).spec_decode == JaxServer._sampling(None, body).spec_decode, body


# --------------------------------------------------------------------- #
# against the JAX spec engine (slow: each case builds a JAX engine)

PARITY = dict(model_config_name="debug", dtype="float32", max_batch_size=2, max_seq_len=128,
              prefill_chunk=16, page_size=8, decode_block=4)


@pytest.mark.slow
@pytest.mark.parametrize("layout", ["paged", "fixed"])
@pytest.mark.parametrize("pipeline", ["on", "off"])
@pytest.mark.parametrize("runahead", [1, 4])
def test_spec_streams_equal_the_jax_spec_engine(layout, pipeline, runahead):
    kw = dict(PARITY, kv_layout=layout, decode_runahead=runahead, spec_decode_enable="on",
              spec_pipeline_enable=pipeline)
    jax_engine = JaxEngine(JaxEngineConfig(tensor_parallelism=1, **kw))
    weights = jl.init_params_fast(jl.PRESETS["debug"], 0, jnp.float32)
    port = LLMEngine(EngineConfig(**kw), device="cpu", params=params_from_jax(weights))
    try:
        for prompt, sp in _legs():
            fields = dict(temperature=sp.temperature, top_p=sp.top_p, max_tokens=sp.max_tokens,
                          seed=sp.seed, spec_decode=sp.spec_decode)
            ref = list(jax_engine.iter_ids(prompt, JaxParams(**fields), timeout=600))
            out = list(port.iter_ids(prompt, SamplingParams(**fields), timeout=600))
            assert out == ref, prompt
    finally:
        jax_engine.shutdown()
        port.shutdown()


def test_spec_streams_equal_the_jax_spec_engine_tier1():
    """One engine-against-engine case in tier 1: paged, lookup,
    pipelined, greedy copy-heavy and seeded rows."""
    kw = dict(PARITY, kv_layout="paged", spec_decode_enable="on")
    jax_engine = JaxEngine(JaxEngineConfig(tensor_parallelism=1, **kw))
    port = LLMEngine(EngineConfig(**kw), device="cpu",
                     params=params_from_jax(jl.init_params_fast(jl.PRESETS["debug"], 0, jnp.float32)))
    try:
        for prompt, sp in _legs()[:4]:
            fields = dict(temperature=sp.temperature, top_p=sp.top_p, max_tokens=sp.max_tokens,
                          seed=sp.seed)
            ref = list(jax_engine.iter_ids(prompt, JaxParams(**fields), timeout=600))
            out = list(port.iter_ids(prompt, SamplingParams(**fields), timeout=600))
            assert out == ref, prompt
        assert port.stats()["spec_verify_dispatches"] > 0
    finally:
        jax_engine.shutdown()
        port.shutdown()
