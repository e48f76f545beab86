"""The port's framework connectors (generativeaiexamples_tpu_torch/
integrations/: ``langchain``, ``llamaindex``, ``pandasai``) against the
root ``integrations/`` package, which serves the JAX package.

- Over one scripted backend (the same pieces for both): the same text and
  chunks from ``ChatTPU.invoke``/``stream``/``predict``, the LlamaIndex
  LLM's ``complete``/``stream_complete``/``chat``/``stream_chat`` and
  PandasAI's ``TPULLM.call``; the same arguments reach the backend; the same
  message normalization; the same span names, attributes and events in
  each package's tracer (times and ids aside).
- Over each package's tiny in-process engine on the same float32 weights
  (the ``debug`` preset), greedy: the same text through every adapter.
- Embeddings: the adapters return their embedder's vectors, and the two
  packages' agree within 1e-5 over the same (hash) embedder.
- The LlamaIndex retriever over each package's chain runtime with the same
  documents: each adapter's nodes are its runtime's hits, and under the
  dense pipeline the two packages' nodes are equal, scores within 1e-5 and
  runs of tied scores as sets.
"""
import numpy as np
import pytest

from generativeaiexamples_tpu.engine.embedder import HashEmbedder as JHash
from generativeaiexamples_tpu.utils import tracing as jtracing
from generativeaiexamples_tpu_torch.engine.embedder import HashEmbedder as THash
from generativeaiexamples_tpu_torch.integrations import langchain as tlc
from generativeaiexamples_tpu_torch.integrations import llamaindex as tli
from generativeaiexamples_tpu_torch.integrations import pandasai as tpa
from generativeaiexamples_tpu_torch.utils import tracing as ttracing
from integrations import langchain_tpu as jlc
from integrations import llamaindex_tpu as jli
from integrations import pandasai_tpu as jpa
from tests.test_torch_chain_runtime import _assert_same_dense, runtimes  # noqa: F401 - a fixture

EMB_TOL = 1e-5
PACKAGES = {"jax": (jlc, jli, jpa, jtracing), "port": (tlc, tli, tpa, ttracing)}


class _Scripted:
    """A backend that streams fixed pieces and records each call."""

    def __init__(self, pieces):
        self.pieces = list(pieces)
        self.calls = []

    def stream_chat(self, messages, **kwargs):
        self.calls.append((list(messages), dict(kwargs)))
        return iter(self.pieces)

    def complete(self, messages, **kwargs):
        return "".join(self.stream_chat(messages, **kwargs))


def _pieces(seed):
    rng = np.random.default_rng(seed)
    words = ["tok", "en", " a", "é", " ü", "\n", " 42", "", " the", "--"]
    return [str(rng.choice(words)) * int(rng.integers(1, 3)) for _ in range(int(rng.integers(3, 9)))]


MESSAGE_SHAPES = [
    "bare prompt",
    [("system", "be brief"), ("user", "hi")],
    [{"role": "user", "content": "from a dict"}, {"content": 5}],
]


class _LangChainMessage:
    def __init__(self, type_, content):
        self.type, self.content = type_, content


def _drive_adapters(pkg, seed):
    lc, li, pa, _ = PACKAGES[pkg]
    out, backends = {}, []

    def backend():
        backends.append(_Scripted(_pieces(seed)))
        return backends[-1]

    for i, msgs in enumerate(MESSAGE_SHAPES + [[_LangChainMessage("human", "obj"),
                                                _LangChainMessage("ai", "prior"),
                                                _LangChainMessage("tool", 3)]]):
        chat = lc.ChatTPU(backend=backend(), temperature=0.5, top_p=0.8, max_tokens=17)
        out[f"stream{i}"] = list(chat.stream(msgs, stop=["x"]))
        out[f"invoke{i}"] = chat.invoke(msgs, temperature=0.1, max_tokens=3)
    out["predict"] = lc.ChatTPU(backend=backend()).predict("compat")
    llm = li.TPULlamaIndexLLM(backend=backend(), max_tokens=9)
    out["complete"] = llm.complete("p").text
    out["stream_complete"] = [(r.text, r.delta) for r in llm.stream_complete("p")]
    out["chat"] = (llm.chat([("user", "c")]).message.role, llm.chat([("user", "c")]).message.content)
    out["stream_chat"] = [(r.message.content, r.delta) for r in llm.stream_chat([("user", "c")])]
    out["metadata"] = llm.metadata

    class Prompt:  # PandasAI passes prompt objects with to_string()
        def to_string(self):
            return "generate pandas code"

    pandas = pa.TPULLM(backend=backend(), temperature=0.3)
    out["call"] = (pandas.call(Prompt(), suffix="\n# df"), pandas.call("plain"), pandas.type)
    out["backend_calls"] = [b.calls for b in backends]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adapters_over_a_scripted_backend_are_jax_s(seed):
    got, want = _drive_adapters("port", seed), _drive_adapters("jax", seed)
    assert got == want
    assert got["invoke0"] == "".join(_pieces(seed))


def test_message_normalization_is_jax_s():
    shapes = MESSAGE_SHAPES + [
        [_LangChainMessage("human", "obj"), _LangChainMessage("ai", "x"),
         _LangChainMessage("system", 7), ("assistant", 3)],
        [], "",
    ]
    for msgs in shapes:
        assert tlc._normalize_messages(msgs) == jlc._normalize_messages(msgs)
    assert tlc._normalize_messages("bare") == [("user", "bare")]


def _spans(pkg, seed, fail=False):
    lc, _, _, tracing = PACKAGES[pkg]
    exporter = tracing.InMemorySpanExporter()
    tracing.set_tracer(tracing.Tracer(exporter=exporter, flush_interval=0.05))
    try:
        backend = _Scripted(_pieces(seed))
        if fail:
            def broken(messages, **kwargs):
                yield "partial"
                raise RuntimeError("backend died")

            backend.stream_chat = broken
        chat = lc.ChatTPU(backend=backend, max_tokens=16)
        with tracing.get_tracer().span("caller"):
            try:
                "".join(chat.stream([("user", "trace me"), ("user", "twice")]))
            except RuntimeError:
                assert fail
            gen = chat.stream("abandoned")  # an early stop is not an error
            next(gen, None)
            gen.close()
        emb = lc.TPUEmbeddings(embedder=(JHash if pkg == "jax" else THash)(dimensions=16))
        emb.embed_documents(["a", "b"])
        emb.embed_query("q")
        tracing.get_tracer().force_flush()
        return [(s.name, s.status, s.attributes,
                 [(e["name"], e["attributes"]) for e in s.events],
                 s.parent_id is not None) for s in exporter.spans]
    finally:
        tracing.reset_tracer()


@pytest.mark.parametrize("fail", [False, True], ids=["ok", "backend_error"])
@pytest.mark.parametrize("seed", [0, 1])
def test_spans_attributes_and_events_are_jax_s(seed, fail):
    got, want = _spans("port", seed, fail), _spans("jax", seed, fail)
    assert got == want
    names = [s[0] for s in got]
    assert names.count("llm.chat") == 2 and "embedder.embed_documents" in names
    chat = next(s for s in got if s[0] == "llm.chat")
    assert set(chat[2]) == {"llm.temperature", "llm.top_p", "llm.max_tokens", "llm.messages",
                            "llm.chunks", "llm.completion_chars", "service.name"}
    assert chat[2]["llm.messages"] == 2 and chat[4]  # parented to the caller's span
    assert all(e[0] in ("llm.new_token", "exception") for e in chat[3])


@pytest.fixture(scope="module")
def engines():
    """The JAX engine and the port's on the same float32 debug weights."""
    import jax.numpy as jnp

    from generativeaiexamples_tpu.config import EngineConfig as JaxEngineConfig
    from generativeaiexamples_tpu.engine.llm_engine import LLMEngine as JaxEngine
    from generativeaiexamples_tpu.models import llama as jl
    from generativeaiexamples_tpu_torch.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine
    from generativeaiexamples_tpu_torch.models.convert import params_from_jax

    common = dict(model_config_name="debug", max_batch_size=2, max_seq_len=128,
                  prefill_chunk=16, dtype="float32", page_size=16)
    jax_engine = JaxEngine(JaxEngineConfig(tensor_parallelism=1, serving_layout="layered",
                                           **common))
    weights = jl.init_params_fast(jl.PRESETS["debug"], 0, jnp.float32)
    port = LLMEngine(EngineConfig(**common), device="cpu", params=params_from_jax(weights))
    yield jax_engine, port
    jax_engine.shutdown()
    port.shutdown()


def _engine_texts(pkg, engine):
    from generativeaiexamples_tpu.engine.llm_backend import TPULLMBackend
    from generativeaiexamples_tpu_torch.engine.llm_backend import TorchLLMBackend

    lc, li, pa, _ = PACKAGES[pkg]
    backend = TPULLMBackend(engine=engine) if pkg == "jax" else TorchLLMBackend(engine=engine)
    greedy = dict(temperature=0.0, max_tokens=12)
    chat = lc.ChatTPU(backend=backend, top_p=1.0, **greedy)
    msgs = [("system", "terse"), ("user", "abc abc abc")]
    llm = li.TPULlamaIndexLLM(backend=backend, top_p=1.0, **greedy)
    pandas = pa.TPULLM(backend=backend, top_p=1.0, **greedy)
    return {
        "invoke": chat.invoke(msgs), "stream": "".join(chat.stream(msgs)),
        "backend": "".join(backend.stream_chat(msgs, top_p=1.0, **greedy)),
        "complete": llm.complete("tell me xyz").text,
        "stream_complete": [r.delta for r in llm.stream_complete("tell me xyz")],
        "call": pandas.call("write code"),
    }


def test_adapters_over_each_engine_give_the_same_greedy_text(engines):
    jax_engine, port = engines
    got, want = _engine_texts("port", port), _engine_texts("jax", jax_engine)
    assert got == want
    assert got["invoke"] == got["stream"] == got["backend"]
    assert "".join(got["stream_complete"]) == got["complete"]


@pytest.mark.parametrize("dims", [16, 64])
def test_embeddings_are_jax_s_within_tolerance(dims):
    texts = [f"doc {i} about caches and pages" * (1 + i % 3) for i in range(9)]
    tl, jl = tlc.TPUEmbeddings(embedder=THash(dims)), jlc.TPUEmbeddings(embedder=JHash(dims))
    got, want = np.array(tl.embed_documents(texts)), np.array(jl.embed_documents(texts))
    assert got.shape == (9, dims) and np.abs(got - want).max() <= EMB_TOL
    assert np.abs(np.array(tl.embed_query("q caches")) - np.array(jl.embed_query("q caches"))
                  ).max() <= EMB_TOL
    tli_emb = tli.TPULlamaIndexEmbedding(embedder=THash(dims))
    assert np.array_equal(np.array(tli_emb.get_text_embedding_batch(texts)), got)
    assert tli_emb.get_text_embedding(texts[0]) == tl.embed_documents(texts[:1])[0]
    assert tli_emb.get_query_embedding("q caches") == tl.embed_query("q caches")


def test_the_in_process_embedder_is_the_runtime_s(runtimes):  # noqa: F811
    from generativeaiexamples_tpu_torch.chains import runtime as trt

    emb = tlc.TPUEmbeddings()
    assert emb._embedder is trt.get_embedder()
    texts = ["alpha beta", "gamma"]
    assert emb.embed_documents(texts) == np.asarray(
        trt.get_embedder().embed_documents(texts)).tolist()


def _hits(nodes):
    """Nodes as the runtime's hits, for the dense comparison."""
    from generativeaiexamples_tpu_torch.retrieval.store import Chunk, SearchHit

    return [SearchHit(Chunk(n.node.text, n.node.metadata["filename"]), n.score) for n in nodes]


@pytest.mark.parametrize("runtimes", ["dense", "ranked_hybrid"], indirect=True)
def test_the_llamaindex_retriever_over_each_runtime_is_jax_s(runtimes):  # noqa: F811
    """The dense pipeline's nodes equal JAX's up to ties of the hash
    embedder (runs of equal scores as sets, as the runtime's own parity
    test compares them); under ranked_hybrid a tie at the fetch cut can
    hand the reranker other candidates, so there each adapter is held to
    its own runtime's answer."""
    from generativeaiexamples_tpu.chains import runtime as jrt
    from generativeaiexamples_tpu_torch.chains import runtime as trt

    jcfg, tcfg, docs = runtimes
    for doc in docs[:5]:
        query = doc.split(". ")[1]
        for top_k, threshold in ((None, None), (2, 0.0), (6, 0.1)):
            got = tli.TPULlamaIndexRetriever(top_k=top_k, score_threshold=threshold).retrieve(query)
            want = jli.TPULlamaIndexRetriever(top_k=top_k, score_threshold=threshold).retrieve(query)
            for nodes, rt in ((got, trt), (want, jrt)):
                hits = rt.retrieve(query, top_k=top_k, score_threshold=threshold)
                assert [(n.node.text, n.node.metadata, n.score) for n in nodes] == [
                    (h.chunk.text, {"filename": h.chunk.source, **h.chunk.metadata}, h.score)
                    for h in hits]
            assert got and got[0].get_content() == got[0].node.text
            if tcfg.retriever.nr_pipeline == "dense":
                k = top_k or tcfg.retriever.top_k
                _assert_same_dense(_hits(got), _hits(want), cut=len(want) == k)
