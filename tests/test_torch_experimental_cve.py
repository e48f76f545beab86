"""The port's CVE triage (generativeaiexamples_tpu_torch/experimental/
cve_analysis/) against the JAX repository's experimental/cve_analysis/ on
the CPU:

- the CVE tests of tests/test_experimental_agents.py on the port;
- ``compare_versions``, ``version_matches``, ``parse_checklist`` and
  ``_first_json`` equal to JAX's on planted and hypothesis-drawn inputs;
- ``SBOMChecker.from_csv`` under each header alias: the same map, checks
  and sentences;
- the agent and the pipeline over one scripted LLM a package: the same
  messages and settings handed to the LLM, the same traces and the same
  ``as_dict``;
- the slice: ``pipeline.main`` of both packages in process over the echo
  backend and a scripted one installed in each runtime, with an SBOM and
  a code collection: the same JSONL;
- ``_load_cves`` equal on CSV, JSONL and plain files; the CLI raises with
  no card and no ``--device``; the new modules import no JAX, no JAX
  package, no root ``experimental`` or ``tools``, no aiohttp or requests.
"""
import json
import os
import pathlib
import subprocess
import sys
import threading

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from experimental.cve_analysis import agent as jagent
from experimental.cve_analysis import checklist as jchecklist
from experimental.cve_analysis import pipeline as jpipeline
from experimental.cve_analysis import tools as jtools
from generativeaiexamples_tpu.chains import runtime as jruntime
from generativeaiexamples_tpu.config import get_config as jget_config
from generativeaiexamples_tpu.engine.embedder import HashEmbedder as JHash
from generativeaiexamples_tpu.retrieval.store import Chunk as JChunk
from generativeaiexamples_tpu_torch import config as tconfig
from generativeaiexamples_tpu_torch.chains import runtime as truntime
from generativeaiexamples_tpu_torch.engine.embedder import HashEmbedder
from generativeaiexamples_tpu_torch.experimental.cve_analysis import (
    CVEPipeline,
    SBOMChecker,
    version_in_range,
)
from generativeaiexamples_tpu_torch.experimental.cve_analysis import agent as tagent
from generativeaiexamples_tpu_torch.experimental.cve_analysis import checklist as tchecklist
from generativeaiexamples_tpu_torch.experimental.cve_analysis import pipeline as tpipeline
from generativeaiexamples_tpu_torch.experimental.cve_analysis import tools as ttools
from generativeaiexamples_tpu_torch.experimental.cve_analysis.agent import ChecklistAgent
from generativeaiexamples_tpu_torch.experimental.cve_analysis.checklist import parse_checklist
from generativeaiexamples_tpu_torch.experimental.cve_analysis.tools import (
    CodeSearchTool,
    compare_versions,
    version_at_most,
    version_matches,
)
from generativeaiexamples_tpu_torch.retrieval.store import Chunk, create_vector_store

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "generativeaiexamples_tpu", "experimental", "tools", "aiohttp", "requests")
NEW_MODULES = [
    "generativeaiexamples_tpu_torch.experimental.cve_analysis",
    "generativeaiexamples_tpu_torch.experimental.cve_analysis.tools",
    "generativeaiexamples_tpu_torch.experimental.cve_analysis.checklist",
    "generativeaiexamples_tpu_torch.experimental.cve_analysis.agent",
    "generativeaiexamples_tpu_torch.experimental.cve_analysis.pipeline",
]


class ScriptedLLM:
    """Returns queued responses in order; repeats the last one (the JAX
    test's), recording each call's messages and settings."""

    def __init__(self, responses):
        self.responses = list(responses)
        self.calls = []

    def complete(self, messages, **kwargs):
        self.calls.append((list(messages), kwargs))
        if len(self.responses) > 1:
            return self.responses.pop(0)
        return self.responses[0]

    def stream_chat(self, messages, **kwargs):
        yield self.complete(messages, **kwargs)


class ContentLLM:
    """Replies by what it is asked, not by call order (CVEs run in
    parallel threads): a checklist, then per item a code search, an SBOM
    check and a final finding, then a verdict. Records every call."""

    def __init__(self):
        self.calls = []
        self._lock = threading.Lock()

    def complete(self, messages, **kwargs):
        with self._lock:
            self.calls.append((list(messages), kwargs))
        system, user = messages[0][1], messages[-1][1]
        if "checklist for a containerized" in system:
            name = user.split(":")[1].split()[0]
            return json.dumps([f"Check the {name} version", f"Check {name} call sites"])
        if "assessing one checklist item" in system:
            tools = user.count("\nTool ")
            if tools == 0:
                return json.dumps({"tool": "code_search", "input": "iterwalk usage"})
            if tools == 1:
                return json.dumps({"tool": "sbom_check", "input": "lxml"})
            if tools == 2:
                return json.dumps({"tool": "version_compare", "input": "4.8.0, 4.9.1"})
            return json.dumps({"final": f"evidence from {tools} tools"})
        return json.dumps({"exploitable": "lxml" in user, "summary": f"{len(user)} chars"})

    def stream_chat(self, messages, **kwargs):
        yield self.complete(messages, **kwargs)


def _sbom_csv(tmp_path):
    path = tmp_path / "sbom.csv"
    path.write_text("name,version\nlxml,4.8.0\nlibxml2,2.9.12\naiohttp,3.9.1\npython3-yaml,6.0\n")
    return str(path)


# --------------------------------------------------------------------------- #
# tests/test_experimental_agents.py (cve_analysis) on the port


def test_version_comparisons():
    assert compare_versions("1.2.3", "1.2.10") < 0  # numeric, not lexical
    assert compare_versions("2.0", "2.0.0") < 0
    assert compare_versions("1.2.3", "1.2.3") == 0
    assert version_at_most("3.11.3", "3.11.3")
    assert not version_at_most("3.11.4", "3.11.3")
    assert version_in_range("2.9.12", "2.9.10", "2.9.14")
    assert not version_in_range("2.9.9", "2.9.10", "2.9.14")
    assert compare_versions("1.0a", "1.0") < 0
    assert compare_versions("1:2.3-1ubuntu1", "1:2.4-1") < 0


def test_version_matches_forms():
    assert version_matches("4.9.0", "4.9.1")
    assert version_matches("2.9.12", "2.9.10, 2.9.14")
    assert version_matches("1.1", "1.0, 1.1, 1.2, 1.3")
    assert not version_matches("1.4", "1.0, 1.1, 1.2, 1.3")
    assert not version_matches("x", "")


def test_sbom_checker(tmp_path):
    csv_path = tmp_path / "sbom.csv"
    csv_path.write_text("name,version\nlxml,4.8.0\nlibxml2,2.9.12\naiohttp,3.9.1\n")
    sbom = SBOMChecker.from_csv(str(csv_path))
    assert sbom.check("lxml") == "4.8.0"
    assert sbom.check("LXML") == "4.8.0"
    assert sbom.check("python3-lxml") == "4.8.0"
    assert sbom.check("rust") is None
    assert "not found" in sbom.describe("rust")


def test_parse_checklist_json_and_numbered():
    assert parse_checklist('["Check A", "Check B"]') == ["Check A", "Check B"]
    items = parse_checklist("1. Check version\n2) Check usage\n- Check config")
    assert items == ["Check version", "Check usage", "Check config"]


def test_agent_runs_tools_then_finals(tmp_path):
    csv_path = tmp_path / "sbom.csv"
    csv_path.write_text("name,version\nlxml,4.8.0\n")
    llm = ScriptedLLM([
        json.dumps({"tool": "sbom_check", "input": "lxml"}),
        json.dumps({"tool": "version_compare", "input": "4.8.0, 4.9.1"}),
        json.dumps({"final": "lxml 4.8.0 is within the vulnerable range."}),
    ])
    agent = ChecklistAgent(llm, sbom=SBOMChecker.from_csv(str(csv_path)))
    trace = agent.run_item("CVE-X lxml through 4.9.1", "Check lxml version")
    assert [s["tool"] for s in trace.steps] == ["sbom_check", "version_compare"]
    assert "4.8.0" in trace.steps[0]["observation"]
    assert "IS within" in trace.steps[1]["observation"]
    assert "vulnerable range" in trace.finding


def test_cve_pipeline_end_to_end(tmp_path):
    csv_path = tmp_path / "sbom.csv"
    csv_path.write_text("name,version\nlxml,4.8.0\n")
    llm = ScriptedLLM([
        '["Check lxml version"]',
        json.dumps({"tool": "sbom_check", "input": "lxml"}),
        json.dumps({"final": "present at 4.8.0, vulnerable"}),
        json.dumps({"exploitable": True, "summary": "lxml vulnerable"}),
    ])
    pipeline = CVEPipeline(llm, sbom=SBOMChecker.from_csv(str(csv_path)), max_concurrency=2)
    verdicts = pipeline.run_sync(["CVE-2022-2309: lxml through 4.9.1 NULL deref"])
    assert len(verdicts) == 1
    assert verdicts[0].exploitable is True
    assert verdicts[0].checklist == ["Check lxml version"]
    assert verdicts[0].as_dict()["findings"][0]["steps"][0]["tool"] == "sbom_check"


def test_code_search_tool():
    embedder = HashEmbedder(dimensions=32)
    store = create_vector_store("faiss", dimensions=32)
    store.add([Chunk(text="from lxml import iterwalk", source="app.py")],
              embedder.embed_documents(["from lxml import iterwalk"]))
    assert "iterwalk" in CodeSearchTool(embedder, store).search("iterwalk usage")
    empty = CodeSearchTool(embedder, create_vector_store("faiss", dimensions=32))
    assert "No matching code" in empty.search("anything")


def test_cve_cli_load_formats(tmp_path):
    jsonl = tmp_path / "c.jsonl"
    jsonl.write_text(json.dumps({"cve_info": "desc one"}) + "\nplain line two\n")
    assert tpipeline._load_cves(str(jsonl)) == ["desc one", "plain line two"]
    csvf = tmp_path / "c.csv"
    csvf.write_text("id,description\n1,desc a\n2,desc b\n")
    assert tpipeline._load_cves(str(csvf)) == ["desc a", "desc b"]


# --------------------------------------------------------------------------- #
# the pure functions against JAX's

VERSION_PAIRS = [
    ("1.2.3", "1.2.10"), ("2.0", "2.0.0"), ("1.0a", "1.0"), ("1.0", "1.0.1"),
    ("1:2.3-1ubuntu1", "1:2.4-1"), ("3.11.3", "3.11.3"), ("1.0rc1", "1.0b2"),
    ("v2.9.14", "2.9.14"), ("", "0"), ("ALPHA", "alpha"), ("10", "9.99"), ("1..2", "1.2"),
    ("2.0.0-beta.11", "2.0.0-beta.2"), ("1.0~rc1", "1.0"), ("0.0.0", ""),
]


@pytest.mark.parametrize("a,b", VERSION_PAIRS)
def test_compare_versions_equals_jax_on_planted_pairs(a, b):
    assert compare_versions(a, b) == jtools.compare_versions(a, b)
    assert compare_versions(b, a) == jtools.compare_versions(b, a)
    assert ttools._version_key(a) == jtools._version_key(a)


@pytest.mark.parametrize("installed,vulnerable", [
    ("4.9.0", "4.9.1"), ("4.9.2", "4.9.1"), ("2.9.12", "2.9.10, 2.9.14"),
    ("2.9.15", "2.9.10,2.9.14"), ("1.1", "1.0, 1.1, 1.2, 1.3"), ("1.4", "1.0, 1.1, 1.2, 1.3"),
    ("x", ""), ("1.0", " , ,"), ("1.0", "1.0,"), ("3.0", ",2.0,4.0"), ("1:2.3", "1:2.0, 1:2.5"),
])
def test_version_matches_equals_jax_on_planted_forms(installed, vulnerable):
    assert version_matches(installed, vulnerable) == jtools.version_matches(installed, vulnerable)
    assert version_matches(installed, vulnerable) in (True, False)


_VERSION = st.text(alphabet="0123456789.-:~+abrcAB ", max_size=14)


@settings(max_examples=200, deadline=None, derandomize=True)
@given(_VERSION, _VERSION)
def test_compare_versions_equals_jax_on_drawn_pairs(a, b):
    assert compare_versions(a, b) == jtools.compare_versions(a, b)
    assert version_at_most(a, b) == jtools.version_at_most(a, b)
    assert version_in_range(a, b, a + "1") == jtools.version_in_range(a, b, a + "1")


@settings(max_examples=200, deadline=None, derandomize=True)
@given(_VERSION, st.lists(_VERSION, max_size=5))
def test_version_matches_equals_jax_on_drawn_sets(installed, vulnerable):
    spec = ",".join(vulnerable)
    assert version_matches(installed, spec) == jtools.version_matches(installed, spec)


CHECKLIST_REPLIES = [
    '["Check A", "Check B"]',
    'Sure! Here it is: ["Check the lxml version", "  ", "Check iterwalk"] Hope this helps.',
    '["only whitespace", ""]',
    "[]\n1. fall through to numbered",
    "[not json]\n- bullet one\n* bullet two\n• bullet three",
    "1) first\n2. second\nplain line",
    "Check the installed version of lxml. Check whether the code calls iterwalk. ok",
    "short. tiny",
    "",
    '[1, 2, {"a": 3}]',
    '{"items": ["not", "a list"]}',
    "- \n-\n1.",
]


@pytest.mark.parametrize("raw", CHECKLIST_REPLIES)
def test_parse_checklist_equals_jax_on_planted_replies(raw):
    assert parse_checklist(raw) == jchecklist.parse_checklist(raw)


_PIECES = st.sampled_from(['["', '"]', "[", "]", '", "', "1. ", "2) ", "- ", "* ", "• ", "\n",
                           ". ", "Check the version", "iterwalk", "{", "}", '"final"', ": ",
                           "true", "null", " ", "lxml 4.9.1", ","])
_REPLY = st.lists(_PIECES, max_size=20).map("".join)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(_REPLY)
def test_parse_checklist_equals_jax_on_drawn_replies(raw):
    assert parse_checklist(raw) == jchecklist.parse_checklist(raw)


@pytest.mark.parametrize("raw", [
    '{"tool": "sbom_check", "input": "lxml"}',
    'I will call {"tool": "code_search", "input": "x"} now',
    '{"final": "done"} and {"extra": 1}',
    "no json here",
    "{not json}",
    "[1, 2]",
    '{"a": {"b": [1, 2]}}',
    "{}",
    '{"final": "multi\nline"}',
])
def test_first_json_equals_jax_on_planted_replies(raw):
    assert tagent._first_json(raw) == jagent._first_json(raw)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(_REPLY)
def test_first_json_equals_jax_on_drawn_replies(raw):
    assert tagent._first_json(raw) == jagent._first_json(raw)


def test_prompts_are_jax_s_byte_for_byte():
    assert tchecklist.CHECKLIST_PROMPT == jchecklist.CHECKLIST_PROMPT
    assert tagent.AGENT_PROMPT == jagent.AGENT_PROMPT
    assert tagent.VERDICT_PROMPT == jagent.VERDICT_PROMPT


# --------------------------------------------------------------------------- #
# the SBOM checker


@pytest.mark.parametrize("header", [
    "name,version", "package,version", "package name,package version",
    " Package Name , Package Version ", "NAME,VERSION", "package,package version",
    "id,name,version,license",
])
def test_sbom_from_csv_equals_jax_under_each_header_alias(tmp_path, header):
    path = tmp_path / "sbom.csv"
    cols = [c.strip().lower() for c in header.split(",")]
    rows = [("lxml", "4.8.0"), ("LibXML2", "2.9.12"), ("", "1.0"), ("python3-yaml", " 6.0 ")]
    lines = [header]
    for name, version in rows:
        values = {c: "x" for c in cols}
        for c in cols:
            if "name" in c or c == "package":
                values[c] = name
            if "version" in c:
                values[c] = version
        lines.append(",".join(values[c] for c in cols))
    path.write_text("\n".join(lines) + "\n")
    port, ref = SBOMChecker.from_csv(str(path)), jtools.SBOMChecker.from_csv(str(path))
    assert port.sbom_map == ref.sbom_map
    assert port.sbom_map["lxml"] == "4.8.0"
    for name in ("lxml", "LXML", "libxml2", "python3-lxml", "yaml", "rust", "", " Lxml "):
        assert port.check(name) == ref.check(name)
        assert port.describe(name) == ref.describe(name)


def test_sbom_custom_fields_equal_jax(tmp_path):
    path = tmp_path / "sbom.csv"
    path.write_text("pkg,ver\nlxml,4.8.0\nopenssl,3.0.2\n")
    port = SBOMChecker.from_csv(str(path), name_field="pkg", version_field="ver")
    ref = jtools.SBOMChecker.from_csv(str(path), name_field="pkg", version_field="ver")
    assert port.sbom_map == ref.sbom_map == {"lxml": "4.8.0", "openssl": "3.0.2"}


# --------------------------------------------------------------------------- #
# the agent and the pipeline over scripted LLMs


def _code_stores():
    texts = ["from lxml import etree\nfor ev, el in etree.iterwalk(root): pass",
             "import yaml\nyaml.safe_load(stream)", "def handler(req):\n    return req.body"]
    port, ref = create_vector_store("faiss", dimensions=64), None
    from generativeaiexamples_tpu.retrieval.store import create_vector_store as jcreate

    ref = jcreate("faiss", dimensions=64)
    port.add([Chunk(text=t, source=f"f{i}.py") for i, t in enumerate(texts)],
             HashEmbedder(64).embed_documents(texts))
    ref.add([JChunk(text=t, source=f"f{i}.py") for i, t in enumerate(texts)],
            JHash(64).embed_documents(texts))
    return (CodeSearchTool(HashEmbedder(64), port),
            jtools.CodeSearchTool(JHash(64), ref))


AGENT_SCRIPTS = {
    "tools_then_final": [json.dumps({"tool": "sbom_check", "input": "lxml"}),
                         json.dumps({"tool": "version_compare", "input": "4.8.0, 4.9.1"}),
                         json.dumps({"tool": "code_search", "input": "iterwalk"}),
                         json.dumps({"final": "vulnerable and reachable"})],
    "unparseable": ["  I think it is fine.  "],
    "step_limit": [json.dumps({"tool": "sbom_check", "input": "rust"}),
                   json.dumps({"tool": "version_compare", "input": "1.2"}),
                   json.dumps({"tool": "nmap", "input": "host"}),
                   json.dumps({"tool": "version_compare", "input": "2.0, 1.0, 2.0, 3.0"})],
    "final_first": ['prose {"final": 42} more'],
    "no_tool_key": [json.dumps({"input": "x"}), json.dumps({"final": None})],
}


@pytest.mark.parametrize("script", sorted(AGENT_SCRIPTS))
@pytest.mark.parametrize("tooled", [True, False], ids=["tools", "no_tools"])
def test_agent_item_and_verdict_equal_jax(tmp_path, script, tooled):
    csv_path = _sbom_csv(tmp_path)
    port_search, ref_search = _code_stores() if tooled else (None, None)
    port_llm = ScriptedLLM(AGENT_SCRIPTS[script] + ['{"exploitable": true, "summary": "s"}'])
    ref_llm = ScriptedLLM(AGENT_SCRIPTS[script] + ['{"exploitable": true, "summary": "s"}'])
    port = ChecklistAgent(port_llm, sbom=SBOMChecker.from_csv(csv_path) if tooled else None,
                          code_search=port_search)
    ref = jagent.ChecklistAgent(ref_llm, sbom=jtools.SBOMChecker.from_csv(csv_path)
                                if tooled else None, code_search=ref_search)
    got = port.run_item("CVE-2022-2309 lxml through 4.9.1", "Check lxml")
    want = ref.run_item("CVE-2022-2309 lxml through 4.9.1", "Check lxml")
    assert (got.item, got.steps, got.finding) == (want.item, want.steps, want.finding)
    assert port.verdict("CVE-X", [got]) == ref.verdict("CVE-X", [want])
    assert port_llm.calls == ref_llm.calls
    assert all(kw["temperature"] == 0.0 for _, kw in port_llm.calls)
    assert [kw["max_tokens"] for _, kw in port_llm.calls][-1] == 512


@pytest.mark.parametrize("reply", [
    '{"exploitable": false, "summary": "not reachable"}',
    "no JSON at all ",
    '{"exploitable": "yes"}',
    '{"summary": 7}',
])
def test_verdict_equals_jax(reply):
    port_llm, ref_llm = ScriptedLLM([reply]), ScriptedLLM([reply])
    traces = [tagent.AgentTrace("item a", [], "finding a"), tagent.AgentTrace("b", [], "fb")]
    jtraces = [jagent.AgentTrace("item a", [], "finding a"), jagent.AgentTrace("b", [], "fb")]
    assert ChecklistAgent(port_llm).verdict("CVE-1", traces) == \
        jagent.ChecklistAgent(ref_llm).verdict("CVE-1", jtraces)
    assert port_llm.calls == ref_llm.calls


@pytest.mark.parametrize("max_steps", [1, 2, 4])
def test_step_limit_finding_equals_jax(max_steps):
    reply = [json.dumps({"tool": "sbom_check", "input": "lxml"})]
    port = ChecklistAgent(ScriptedLLM(reply), sbom=SBOMChecker({"lxml": "4.8.0"}),
                          max_steps=max_steps)
    ref = jagent.ChecklistAgent(ScriptedLLM(reply), sbom=jtools.SBOMChecker({"lxml": "4.8.0"}),
                                max_steps=max_steps)
    got, want = port.run_item("c", "i"), ref.run_item("c", "i")
    assert got.finding.startswith("Step limit reached; evidence: ")
    assert (got.steps, got.finding) == (want.steps, want.finding)
    assert len(got.steps) == max_steps


def test_generate_checklist_settings_equal_jax():
    port_llm, ref_llm = ScriptedLLM(["1. a\n2. b"]), ScriptedLLM(["1. a\n2. b"])
    assert tchecklist.generate_checklist(port_llm, "CVE-9") == \
        jchecklist.generate_checklist(ref_llm, "CVE-9") == ["a", "b"]
    assert port_llm.calls == ref_llm.calls
    assert port_llm.calls[0][1] == {"temperature": 0.0, "max_tokens": 512}


@pytest.mark.parametrize("max_items", [1, 8])
def test_pipeline_as_dicts_and_calls_equal_jax(tmp_path, max_items):
    csv_path = _sbom_csv(tmp_path)
    port_search, ref_search = _code_stores()
    cves = [f"CVE-2024-{i:04d}: lxml{i} through 4.9.{i} NULL deref" for i in range(5)]
    port_llm, ref_llm = ContentLLM(), ContentLLM()
    port = CVEPipeline(port_llm, sbom=SBOMChecker.from_csv(csv_path), code_search=port_search,
                       max_concurrency=3, max_checklist_items=max_items)
    ref = jpipeline.CVEPipeline(ref_llm, sbom=jtools.SBOMChecker.from_csv(csv_path),
                                code_search=ref_search, max_concurrency=3,
                                max_checklist_items=max_items)
    got = [v.as_dict() for v in port.run_sync(cves)]
    want = [v.as_dict() for v in ref.run_sync(cves)]
    assert got == want
    assert [d["cve_info"] for d in got] == cves  # gather keeps the input order
    assert len(got[0]["checklist"]) == min(2, max_items)

    def key(call):
        return json.dumps(call, sort_keys=True)

    assert sorted(map(key, port_llm.calls)) == sorted(map(key, ref_llm.calls))
    # per CVE: 1 checklist call, 4 an item (3 tools, then final), 1 verdict
    assert len(port_llm.calls) == len(cves) * (2 + 4 * min(2, max_items))


def test_pipeline_runs_cves_in_parallel_threads():
    seen, gate = set(), threading.Barrier(3, timeout=30)

    class Gated(ContentLLM):
        def complete(self, messages, **kwargs):
            if "checklist for a containerized" in messages[0][1]:
                seen.add(threading.get_ident())
                gate.wait()  # three CVEs reach here together, or this times out
            return super().complete(messages, **kwargs)

    verdicts = CVEPipeline(Gated(), max_concurrency=3).run_sync(["a: x", "b: y", "c: z"])
    assert len(verdicts) == 3 and len(seen) == 3


# --------------------------------------------------------------------------- #
# the slice: main of both packages over each runtime


@pytest.fixture
def cve_env(monkeypatch, tmp_path):
    """A clean APP_* environment (echo LLM, hash embeddings, faiss store),
    each package's store under its own directory; the port on the CPU."""
    for key in list(os.environ):
        if key.startswith("APP_") or key in ("EXAMPLE_NAME", "COLLECTION_NAME"):
            monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("APP_LLM_MODELENGINE", "echo")
    monkeypatch.setenv("APP_EMBEDDINGS_MODELENGINE", "hash")
    monkeypatch.setenv("APP_EMBEDDINGS_DIMENSIONS", "64")
    monkeypatch.setenv("APP_VECTORSTORE_NAME", "faiss")
    jruntime.reset_runtime()
    truntime.reset_runtime()
    truntime.set_device("cpu")
    monkeypatch.setenv("APP_VECTORSTORE_PERSISTDIR", str(tmp_path / "jax"))
    jget_config()
    monkeypatch.setenv("APP_VECTORSTORE_PERSISTDIR", str(tmp_path / "port"))
    tconfig.get_config()
    yield
    jruntime.reset_runtime()
    truntime.reset_runtime()
    truntime.set_device(None)
    jget_config.cache_clear()
    tconfig.get_config.cache_clear()


def _cve_files(tmp_path):
    cves = tmp_path / "cves.jsonl"
    cves.write_text("\n".join([
        json.dumps({"cve_info": "CVE-2022-2309: lxml through 4.9.1 NULL deref in iterwalk"}),
        json.dumps({"description": "CVE-2020-1747: yaml full_load runs arbitrary code"}),
        "CVE-2023-0001: libxml2 2.9.10 to 2.9.14 overflow",
        "",
    ]) + "\n")
    return str(cves), _sbom_csv(tmp_path)


@pytest.mark.parametrize("backend", ["echo", "scripted"])
def test_main_writes_jax_s_jsonl(cve_env, tmp_path, monkeypatch, backend):
    cves, sbom = _cve_files(tmp_path)
    code = ["for ev, el in etree.iterwalk(root): pass", "yaml.full_load(stream)"]
    jruntime.get_vector_store("code").add([JChunk(text=t, source=f"c{i}.py")
                                           for i, t in enumerate(code)],
                                          jruntime.get_embedder().embed_documents(code))
    truntime.get_vector_store("code").add([Chunk(text=t, source=f"c{i}.py")
                                           for i, t in enumerate(code)],
                                          truntime.get_embedder().embed_documents(code))
    if backend == "scripted":
        port_llm, ref_llm = ContentLLM(), ContentLLM()
        monkeypatch.setattr(truntime, "get_llm", lambda *a, **k: port_llm)
        monkeypatch.setattr(jruntime, "get_llm", lambda *a, **k: ref_llm)
    args = ["--cves", cves, "--sbom", sbom, "--code-collection", "code", "--concurrency", "2"]
    assert tpipeline.main(args + ["--out", str(tmp_path / "port.jsonl"), "--device", "cpu"]) == 0
    assert jpipeline.main(args + ["--out", str(tmp_path / "jax.jsonl")]) == 0
    port = (tmp_path / "port.jsonl").read_text()
    assert port == (tmp_path / "jax.jsonl").read_text()
    rows = [json.loads(line) for line in port.splitlines()]
    assert len(rows) == 3
    assert all(set(r) == {"cve_info", "checklist", "findings", "exploitable", "summary"}
               for r in rows)
    if backend == "scripted":
        steps = rows[0]["findings"][0]["steps"]
        assert [s["tool"] for s in steps] == ["code_search", "sbom_check", "version_compare"]
        assert "iterwalk" in steps[0]["observation"]


def test_main_to_stdout_equals_jax(cve_env, tmp_path, capsys):
    cves, _ = _cve_files(tmp_path)
    assert tpipeline.main(["--cves", cves, "--device", "cpu"]) == 0
    port = capsys.readouterr().out
    assert jpipeline.main(["--cves", cves]) == 0
    assert port == capsys.readouterr().out
    assert len(port.splitlines()) == 3


@pytest.mark.parametrize("kind", ["csv", "jsonl", "plain"])
def test_load_cves_equals_jax(tmp_path, kind):
    if kind == "csv":
        path = tmp_path / "c.csv"
        path.write_text("ID, Description ,cve_info\n1,desc a,\n2,,info b\n3, ,\n4,\"quoted, d\",\n")
    elif kind == "jsonl":
        path = tmp_path / "c.jsonl"
        path.write_text("\n".join([json.dumps({"cve_info": " one "}), json.dumps({"x": 1}),
                                   json.dumps([1, 2]), json.dumps({"description": "two"}),
                                   "not json", "", "   ", '"a string"']) + "\n")
    else:
        path = tmp_path / "c.txt"
        path.write_text("CVE-1 first\n\nCVE-2 second\n{broken json\n")
    assert tpipeline._load_cves(str(path)) == jpipeline._load_cves(str(path))
    assert tpipeline._load_cves(str(path))


def test_cli_raises_with_no_card_and_no_device(cve_env, tmp_path, monkeypatch):
    cves, _ = _cve_files(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    truntime.set_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipeline.main(["--cves", cves])


def test_new_modules_import_no_jax_and_no_root_packages():
    code = ("import importlib, json, sys\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(NEW_MODULES) <= set(loaded)
    assert [m for m in loaded if m.split(".")[0] in FORBIDDEN] == []
