"""The port's structured-data chain (generativeaiexamples_tpu_torch/chains/
structured_data.py) against the JAX package's, on the CPU, at equality.

- ``parse_prompt_config`` (each package's own YAML copy) with and without
  ``CSV_PROMPTS``, a bad value among them, a missing file and a malformed
  one; ``get_prompt_params`` with ``CSV_NAME`` unset, empty, unknown and
  known; ``is_result_valid`` over frames, series, arrays, 0, None and
  ambiguous values; ``extract_df_desc`` (``random_state=0``).
- ``run_pandas_code``: the programs of the JAX sandbox test
  (tests/test_chains.py) and more, the refused ``__import__`` among them;
  values, printed results and exceptions (type and message) equal.
- ``CSVChatbot``: ingest, the column-mismatch message, concatenation of two
  files with ``fillna``, and ``rag_chain`` with one scripted LLM in both
  packages (a good program; two failures then a good one; three failures
  giving ``NO_CONTEXT_MSG``; an empty result; no file ingested): the
  messages the LLM sees, retry prompts included, and the answers are
  equal. Then delete and get documents.

``INGESTED_CSV_FILES_LIST`` is relative to the working directory, so
each package runs in a directory of its own (``_in``), restored after.
"""
import contextlib
import json
import os

import numpy as np
import pandas as pd
import pytest

from generativeaiexamples_tpu.chains import runtime as jrt
from generativeaiexamples_tpu.chains import structured_data as jsd
from generativeaiexamples_tpu_torch.chains import runtime as trt
from generativeaiexamples_tpu_torch.chains import structured_data as tsd
from generativeaiexamples_tpu_torch.chains.developer_rag import NO_CONTEXT_MSG

PKGS = ((jsd, jrt), (tsd, trt))


@contextlib.contextmanager
def _in(path):
    """Run in ``path`` (made if missing), then return to where we were."""
    old = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _outcome(fn, *args, **kwargs):
    """("ok", value) or (exception type name, message)."""
    try:
        return "ok", fn(*args, **kwargs)
    except Exception as exc:  # noqa: BLE001 - compared between packages
        return type(exc).__name__, str(exc)


class ScriptedLLM:
    """``complete`` returns the next queued reply; ``stream_chat`` streams
    it word by word; every call's messages and settings are recorded."""

    def __init__(self, replies):
        self.replies, self.calls = list(replies), []

    def _next(self, kind, messages, kwargs):
        self.calls.append((kind, [tuple(m) for m in messages], sorted(kwargs.items())))
        return self.replies.pop(0) if self.replies else "(exhausted)"

    def complete(self, messages, **kwargs):
        return self._next("complete", messages, kwargs)

    def stream_chat(self, messages, **kwargs):
        return iter(w + " " for w in self._next("stream", messages, kwargs).split(" "))


def _errors_frame(rng, n):
    """Rows of the Azure predictive-maintenance errors table's shape."""
    start = np.datetime64("2015-01-01T06:00:00")
    hours = np.sort(rng.randint(0, 24 * 365, n))
    return pd.DataFrame({
        "datetime": [str(start + np.timedelta64(int(h), "h")).replace("T", " ") for h in hours],
        "machineID": rng.randint(1, 101, n),
        "errorID": [f"error{k}" for k in rng.randint(1, 6, n)],
    })


@pytest.fixture
def csv_env(tmp_path, monkeypatch):
    """CSV_NAME set, no CSV_PROMPTS; each package's own working directory."""
    monkeypatch.setenv("CSV_NAME", "PdM_errors")
    monkeypatch.delenv("CSV_PROMPTS", raising=False)
    monkeypatch.delenv("CSV_PROMPT_CONFIG", raising=False)
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.RandomState(0)
    frames = {"a.csv": _errors_frame(rng, 40), "b.csv": _errors_frame(rng, 25)}
    frames["b.csv"].loc[3, "machineID"] = np.nan  # fillna(0) makes it 0
    frames["other.csv"] = pd.DataFrame({"machineID": [1, 2], "model": ["m3", "m4"], "age": [18, 7]})
    for name, df in frames.items():
        df.to_csv(data / name, index=False)
    return {"jax": tmp_path / "jax", "port": tmp_path / "port", "data": data}


def _run_both(dirs, fn):
    """``fn(mod, rt)`` in each package's directory; both results."""
    return [_in_run(dirs[key], fn, mod, rt) for key, (mod, rt) in zip(("jax", "port"), PKGS)]


def _in_run(path, fn, *args):
    with _in(path):
        return fn(*args)


# --------------------------------------------------------------------------- #
# prompt config


@pytest.mark.parametrize("env_value", [
    None,
    json.dumps({"csv_prompts": [{"name": "mine", "description": "d", "instructions": "i"}]}),
    "{}",
    "not json",
    json.dumps({"other": []}),
    json.dumps({"csv_prompts": "abc"}),
])
def test_parse_prompt_config(monkeypatch, env_value):
    if env_value is None:
        monkeypatch.delenv("CSV_PROMPTS", raising=False)
    else:
        monkeypatch.setenv("CSV_PROMPTS", env_value)
    got = tsd.parse_prompt_config(tsd.DEFAULT_PROMPT_CONFIG)
    assert got == jsd.parse_prompt_config(jsd.DEFAULT_PROMPT_CONFIG)
    assert {"csv_data_retrieval_template", "csv_response_template", "csv_prompts"} <= set(got)


def test_the_yaml_is_a_copy():
    with open(tsd.DEFAULT_PROMPT_CONFIG, "rb") as fh, open(jsd.DEFAULT_PROMPT_CONFIG, "rb") as gh:
        assert fh.read() == gh.read()


@pytest.mark.parametrize("body", [None, "prompts: [1, 2]\n", "other: 1\n"])
def test_parse_prompt_config_errors(tmp_path, body):
    path = tmp_path / "p.yaml"
    if body is not None:
        path.write_text(body)
    want = _outcome(jsd.parse_prompt_config, str(path))
    assert _outcome(tsd.parse_prompt_config, str(path)) == want
    assert want[0] in ("FileNotFoundError", "ValueError")


@pytest.mark.parametrize("csv_name", [None, "", "unknown", "PdM_machines", "PdM_errors",
                                      "PdM_failures"])
@pytest.mark.parametrize("empty_list", [False, True])
def test_get_prompt_params(monkeypatch, csv_name, empty_list):
    if csv_name is None:
        monkeypatch.delenv("CSV_NAME", raising=False)
    else:
        monkeypatch.setenv("CSV_NAME", csv_name)
    prompts = [] if empty_list else tsd.parse_prompt_config(tsd.DEFAULT_PROMPT_CONFIG)["csv_prompts"]
    assert _outcome(tsd.get_prompt_params, prompts) == _outcome(jsd.get_prompt_params, prompts)


_VALUES = [
    pd.DataFrame(), pd.DataFrame({"a": [1]}), pd.Series([], dtype=float), pd.Series([0]),
    np.array([]), np.array([0, 1]), 0, 0.0, None, "", "text", [], [0], {}, False, True, 7,
    pd.Index([1, 2]), pd.Index([]),
]


@pytest.mark.parametrize("value", _VALUES, ids=range(len(_VALUES)))
def test_is_result_valid(value):
    assert tsd.is_result_valid(value) == jsd.is_result_valid(value)


@pytest.mark.parametrize("n", [1, 2, 3, 50])
def test_extract_df_desc(n):
    df = _errors_frame(np.random.RandomState(n), n)
    assert tsd.extract_df_desc(df) == jsd.extract_df_desc(df)


# --------------------------------------------------------------------------- #
# the generated-code namespace


_PROGRAMS = [
    "df = dfs[0]\nresult = df['x'].sum()\nresult",  # tests/test_chains.py
    "__import__('os').system('true')",  # tests/test_chains.py: refused
    "import os\nresult = 1",
    "open('data.txt').read()",
    "result = len(df)",
    "print(df['x'].max())",
    "x = 1\ny = 2",
    "df[df['x'] > 1]",
    "df['x'].mean()",
    "",
    "   \n\n",
    "def f(:\n  pass",
    "result = sorted(set(df['x']))\nprint('ignored')",
    "for i in range(3):\n    print(i)",
    "undefined_name",
    "result = dfs[0]['y'].str.upper().tolist()",
    "eval('1+1')",
    "globals()",
    "result = pd.DataFrame({'a': [1, 2]})\nresult",
    "raise ValueError('boom')",
]


@pytest.mark.parametrize("code", _PROGRAMS, ids=range(len(_PROGRAMS)))
def test_run_pandas_code(code):
    df = pd.DataFrame({"x": [1, 2, 3], "y": ["a", "b", "c"]})
    got, want = _outcome(tsd.run_pandas_code, code, df), _outcome(jsd.run_pandas_code, code, df)
    assert got[0] == want[0]
    if isinstance(want[1], (pd.DataFrame, pd.Series)):
        assert type(got[1]) is type(want[1]) and got[1].equals(want[1])
    else:
        assert got == want


def test_the_sandbox_builtins_are_jax_s():
    assert sorted(tsd._SAFE_BUILTINS) == sorted(jsd._SAFE_BUILTINS)
    assert all(tsd._SAFE_BUILTINS[k] is jsd._SAFE_BUILTINS[k] for k in jsd._SAFE_BUILTINS)
    assert "__import__" not in tsd._SAFE_BUILTINS
    with pytest.raises(Exception):  # as tests/test_chains.py holds the JAX sandbox
        tsd.run_pandas_code("__import__('os').system('true')", pd.DataFrame({"x": [1]}))


# --------------------------------------------------------------------------- #
# CSVChatbot


def _ingest_all(mod, rt, names):
    bot = mod.CSVChatbot()
    return [_outcome(bot.ingest_docs, f"../data/{n}", n) for n in names], bot.get_documents()


def test_ingest_and_the_column_mismatch(csv_env):
    names = ["a.csv", "b.csv", "other.csv", "notes.txt"]
    outs = _run_both(csv_env, lambda mod, rt: _ingest_all(mod, rt, names))
    assert outs[1] == outs[0]
    results, docs = outs[1]
    assert results[:2] == [("ok", None), ("ok", None)]
    assert results[2] == ("ValueError", "Columns of the file ../data/other.csv do not match the "
                          "reference columns of ../data/a.csv\n file.")
    assert results[3] == ("ValueError", "notes.txt is not a valid CSV file")
    assert docs == ["a.csv", "b.csv"]


def test_concatenation_and_fillna(csv_env):
    def run(mod, rt):
        _ingest_all(mod, rt, ["a.csv", "b.csv"])
        return mod.CSVChatbot().read_and_concatenate_csv(mod.INGESTED_CSV_FILES_LIST).fillna(0)

    jdf, tdf = _run_both(csv_env, run)
    assert tdf.equals(jdf) and len(tdf) == 65 and (tdf["machineID"] == 0).sum() == 1


def test_a_list_edited_to_mismatch_raises_alike(csv_env):
    def run(mod, rt):
        with open(mod.INGESTED_CSV_FILES_LIST, "w", encoding="UTF-8") as fh:
            fh.write("../data/a.csv\n../data/other.csv\n")
        return _outcome(mod.CSVChatbot().read_and_concatenate_csv, mod.INGESTED_CSV_FILES_LIST)

    outs = _run_both(csv_env, run)
    assert outs[1] == outs[0] and outs[1][0] == "ValueError"


_GOOD = "```python\ndf = dfs[0]\nresult = int(df['machineID'].max())\nresult\n```"
_SCRIPTS = {
    "good": [_GOOD, "The largest machine id is 100."],
    "retry": ["```python\ndf = dfs[0]\ndf['nope'].max()\n```", "this is not python at all",
              _GOOD, "Found it."],
    "exhausted": ["not code", "```python\nundefined_name\n```", "```\nraise ValueError('x')\n```"],
    "empty": ["```python\ndf = dfs[0]\ndf[df['machineID'] > 1000]\n```", "```python\n0\n```",
              "Zero."],
    "printed": ["```python\nprint(len(dfs[0]))\n```", "There are 65 rows."],
}


@pytest.mark.parametrize("script", sorted(_SCRIPTS))
def test_rag_chain_with_one_scripted_llm(csv_env, monkeypatch, script):
    def run(mod, rt):
        _ingest_all(mod, rt, ["a.csv", "b.csv"])
        llm = ScriptedLLM(_SCRIPTS[script])
        monkeypatch.setattr(rt, "get_llm", lambda *a, **k: llm)
        answer = "".join(mod.CSVChatbot().rag_chain("What is the largest machine id?", [],
                                                    temperature=0.0, max_tokens=64))
        return answer, llm.calls

    outs = _run_both(csv_env, run)
    assert outs[1] == outs[0]
    answer, calls = outs[1]
    completes = [c for c in calls if c[0] == "complete"]
    if script == "exhausted":
        assert answer == NO_CONTEXT_MSG and len(completes) == 3 and len(calls) == 3
        assert "failed with: name 'undefined_name' is not defined" in completes[2][1][1][1]
    else:
        assert calls[-1][0] == "stream" and answer.strip() == _SCRIPTS[script][-1]
    if script == "retry":
        assert len(completes) == 3
        assert completes[1][1][1][1] == (
            "What is the largest machine id?\n\nYour previous program failed with: 'nope'\n"
            "Return corrected python code.")
    if script == "empty":
        assert "Your previous program failed with: result was empty" in completes[1][1][1][1]
    assert completes[0][2] == [("max_tokens", 64), ("temperature", 0.0)]
    assert "error events per machine" in completes[0][1][0][1]  # CSV_NAME's description


def test_no_file_ingested_and_llm_chain(csv_env, monkeypatch):
    def run(mod, rt):
        llm = ScriptedLLM(["hello back"])
        monkeypatch.setattr(rt, "get_llm", lambda *a, **k: llm)
        bot = mod.CSVChatbot()
        return ("".join(bot.rag_chain("q", [])), "".join(bot.llm_chain("hi", [], max_tokens=8)),
                llm.calls, bot.get_documents(), bot.delete_documents(["a.csv"]))

    outs = _run_both(csv_env, run)
    assert outs[1] == outs[0]
    assert outs[1][0] == "No CSV file ingested" and outs[1][3] == [] and outs[1][4] is True


def test_delete_and_get_documents(csv_env):
    def run(mod, rt):
        _ingest_all(mod, rt, ["a.csv", "b.csv"])
        bot = mod.CSVChatbot()
        before = bot.get_documents()
        ok = bot.delete_documents(["a.csv", "never.csv"])
        with open(mod.INGESTED_CSV_FILES_LIST, encoding="UTF-8") as fh:
            listed = fh.read()
        return before, ok, bot.get_documents(), listed

    outs = _run_both(csv_env, run)
    assert outs[1] == outs[0] == (["a.csv", "b.csv"], True, ["b.csv"], "../data/b.csv\n")
