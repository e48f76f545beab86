"""The structured-data (CSV) chain (``structured_data``,
``structured_data_rag``): a pandas code-generation agent, the port's copy
of the JAX package's generativeaiexamples_tpu/chains/structured_data.py.

The LLM writes a small pandas program against the ingested dataframe; the
chain runs it in a namespace of a few builtins with up to
``MAX_CODE_RETRIES`` attempts, and a second LLM call puts the value into
words. Ingested CSVs are listed in ``ingested_csv_files.txt`` in the
working directory and must share the first file's columns; the prompts
come from ``csv_prompt_config.yaml`` (or ``CSV_PROMPT_CONFIG``), the
dataset's parameters by ``CSV_NAME``, more datasets from ``CSV_PROMPTS``.
The generated program runs in this process, as in the JAX package: its
namespace holds no ``__import__``, which is all that stands between it and
the host. The LLM is the runtime's (the engine on the card unless
``runtime.set_device`` says otherwise).
"""
from __future__ import annotations

import io
import json
import logging
import os
import re
from contextlib import redirect_stdout
from typing import Any, Dict, Generator, List

import pandas as pd
import yaml

from generativeaiexamples_tpu_torch.chains import runtime
from generativeaiexamples_tpu_torch.chains.base import BaseExample
from generativeaiexamples_tpu_torch.chains.developer_rag import NO_CONTEXT_MSG
from generativeaiexamples_tpu_torch.config import get_config

logger = logging.getLogger(__name__)

INGESTED_CSV_FILES_LIST = "ingested_csv_files.txt"
MAX_CODE_RETRIES = 3
DEFAULT_PROMPT_CONFIG = os.path.join(os.path.dirname(__file__), "csv_prompt_config.yaml")


def extract_df_desc(df: pd.DataFrame) -> str:
    """The column names, then up to 3 sample rows (``random_state=0``)."""
    column_names = ", ".join(df.columns)
    sample_rows = df.sample(min(3, len(df)), random_state=0)
    return column_names + "\n" + sample_rows.to_string(header=False, index=False)


def parse_prompt_config(config_path: str) -> Dict[str, Any]:
    """The ``prompts`` of the YAML file, with ``CSV_PROMPTS`` (JSON) appended to
    its ``csv_prompts``; a bad ``CSV_PROMPTS`` is logged and ignored."""
    if not os.path.isfile(config_path):
        raise FileNotFoundError(f"The file {config_path} does not exist")
    with open(config_path, "r", encoding="UTF-8") as fh:
        data = yaml.safe_load(fh)
    if "prompts" not in data or not isinstance(data["prompts"], dict):
        raise ValueError(
            "Invalid YAML structure. Expected a 'prompts' key with a list of dictionaries."
        )
    if "CSV_PROMPTS" in os.environ:
        try:
            env_prompts = json.loads(os.environ["CSV_PROMPTS"])
            if env_prompts:
                data["prompts"]["csv_prompts"].extend(env_prompts["csv_prompts"])
        except Exception as exc:  # noqa: BLE001
            logger.warning("Exception in parsing CSV prompt from environment variable %s", exc)
    return data["prompts"]


def get_prompt_params(prompt_list: List[Dict[str, str]]) -> Dict[str, str]:
    """The description and instructions of the dataset ``CSV_NAME`` names
    ({} for a name the list lacks)."""
    csv_name = os.getenv("CSV_NAME")
    if csv_name is None:
        raise RuntimeError("Environment variable CSV_NAME not found.")
    if csv_name == "":
        raise ValueError("Environment variable CSV_NAME is set to an empty string.")
    if not prompt_list:
        raise ValueError("Config Prompt list is empty")
    for prompt in prompt_list:
        if csv_name == prompt.get("name"):
            logger.info("Using prompt for %s", csv_name)
            return {
                "description": prompt.get("description"),
                "instructions": prompt.get("instructions"),
            }
    return {}


def is_result_valid(result: Any) -> bool:
    """Whether a program's result answers: a non-empty frame, series or
    array, 0, or any other truthy value (True for an ambiguous one)."""
    import numpy as np

    if isinstance(result, (pd.DataFrame, pd.Series)):
        return not result.empty
    if isinstance(result, np.ndarray):
        return result.size > 0
    if result is None:
        return False
    try:
        return bool(result) or result == 0
    except ValueError:  # ambiguous truth value of other array-likes
        return True


_CODE_BLOCK_RE = re.compile(r"```(?:python)?\s*(.*?)```", re.DOTALL)

_SAFE_BUILTINS = {
    name: __builtins__[name] if isinstance(__builtins__, dict) else getattr(__builtins__, name)
    for name in (
        "len", "min", "max", "sum", "range", "float", "int", "str", "bool",
        "sorted", "abs", "round", "enumerate", "zip", "list", "dict", "set",
        "tuple", "print", "isinstance",
    )
}


def run_pandas_code(code: str, df: pd.DataFrame) -> Any:
    """Execute generated pandas code in a restricted namespace.

    The program sees ``dfs`` (list with one dataframe), ``df`` and ``pd``.
    The result is the ``result`` variable if set, else the value printed,
    else the value of the last expression.
    """
    namespace: Dict[str, Any] = {
        "__builtins__": _SAFE_BUILTINS,
        "pd": pd,
        "dfs": [df],
        "df": df,
    }
    stdout = io.StringIO()
    lines = [l for l in code.strip().splitlines() if l.strip()]
    if not lines:
        raise ValueError("empty program")
    # If the last line is a bare expression, capture its value as the result.
    last = lines[-1]
    body = "\n".join(lines[:-1])
    with redirect_stdout(stdout):
        try:
            compiled_last = compile(last, "<agent>", "eval")
            if body:
                exec(compile(body, "<agent>", "exec"), namespace)  # noqa: S102
            value = eval(compiled_last, namespace)  # noqa: S307
        except SyntaxError:
            exec(compile(code, "<agent>", "exec"), namespace)  # noqa: S102
            value = namespace.get("result")
    if value is None:
        value = namespace.get("result")
    if value is None:
        printed = stdout.getvalue().strip()
        value = printed if printed else None
    return value


class CSVChatbot(BaseExample):
    """CSV Q&A via in-repo pandas codegen agent."""

    def compare_csv_columns(self, ref_csv_file: str, current_csv_file: str) -> bool:
        """Whether two CSV files have the same columns."""
        ref_df = pd.read_csv(ref_csv_file.replace("\n", ""))
        curr_df = pd.read_csv(current_csv_file.replace("\n", ""))
        return bool(curr_df.columns.equals(ref_df.columns))

    def read_and_concatenate_csv(self, file_paths_txt: str) -> pd.DataFrame:
        """The CSVs listed in ``file_paths_txt``, one frame; a file whose
        columns differ from the first's raises."""
        with open(file_paths_txt, "r", encoding="UTF-8") as fh:
            file_paths = fh.read().splitlines()
        concatenated = pd.DataFrame()
        reference_columns = None
        reference_file = None
        for i, path in enumerate(file_paths):
            df = pd.read_csv(path)
            if i == 0:
                reference_columns, concatenated, reference_file = df.columns, df, path
            elif not df.columns.equals(reference_columns):
                raise ValueError(
                    f"Columns of the file {path} do not match the reference columns of {reference_file} file."
                )
            else:
                concatenated = pd.concat([concatenated, df], ignore_index=True)
        return concatenated

    def ingest_docs(self, filepath: str, filename: str) -> None:
        """Record a CSV in ``INGESTED_CSV_FILES_LIST`` (relative to the working
        directory) after checking its columns against the first file's."""
        if not filename.endswith(".csv"):
            raise ValueError(f"{filename} is not a valid CSV file")
        with open(INGESTED_CSV_FILES_LIST, "a+", encoding="UTF-8") as fh:
            fh.seek(0)
            ref_csv_path = fh.readline()
            if not ref_csv_path:
                fh.write(filepath + "\n")
            elif self.compare_csv_columns(ref_csv_path, filepath):
                fh.write(filepath + "\n")
            else:
                raise ValueError(
                    f"Columns of the file {filepath} do not match the reference columns of {ref_csv_path} file."
                )
        logger.info("Document %s ingested successfully", filename)

    def llm_chain(self, query: str, chat_history: List[Any], **kwargs: Any) -> Generator[str, None, None]:
        """The chat template and the query (the history is not used)."""
        config = get_config()
        messages = [("system", config.prompts.chat_template), ("user", query)]
        return runtime.get_llm(config).stream_chat(messages, **runtime.llm_settings(kwargs))

    def rag_chain(self, query: str, chat_history: List[Any], **kwargs: Any) -> Generator[str, None, None]:
        """Up to ``MAX_CODE_RETRIES`` code-generation completions, each run by
        ``run_pandas_code`` with the previous error fed back, then the answer
        stream over the result (``NO_CONTEXT_MSG`` when none is valid)."""
        if not os.path.exists(INGESTED_CSV_FILES_LIST):
            return iter(["No CSV file ingested"])
        df = self.read_and_concatenate_csv(INGESTED_CSV_FILES_LIST).fillna(0)
        df_desc = extract_df_desc(df)

        config_path = os.environ.get("CSV_PROMPT_CONFIG", DEFAULT_PROMPT_CONFIG)
        prompt_config = parse_prompt_config(config_path)
        params = get_prompt_params(prompt_config.get("csv_prompts", []))

        settings = runtime.llm_settings(kwargs)
        llm = runtime.get_llm()
        system = prompt_config["csv_data_retrieval_template"].format(
            description=params.get("description", ""),
            instructions=params.get("instructions", "") or "",
            data_frame=df_desc,
        )

        value: Any = None
        error = ""
        for attempt in range(MAX_CODE_RETRIES):
            user = query if not error else (
                f"{query}\n\nYour previous program failed with: {error}\nReturn corrected python code."
            )
            reply = llm.complete([("system", system), ("user", user)], **settings)
            match = _CODE_BLOCK_RE.search(reply)
            code = match.group(1) if match else reply
            try:
                value = run_pandas_code(code, df)
                if is_result_valid(value):
                    break
                error = "result was empty"
            except Exception as exc:  # noqa: BLE001
                error = str(exc)
                logger.info("Generated code failed (attempt %d): %s", attempt + 1, exc)

        logger.info("Result Data Frame: %s", value)
        if not is_result_valid(value):
            logger.warning("Retrieval failed to get any relevant context")
            return iter([NO_CONTEXT_MSG])

        response_prompt = prompt_config["csv_response_template"].format(
            query=query, data=str(value)
        )
        return llm.stream_chat([("user", response_prompt)], **settings)

    def get_documents(self) -> List[str]:
        """The base names of the ingested CSVs."""
        names = []
        if os.path.exists(INGESTED_CSV_FILES_LIST):
            with open(INGESTED_CSV_FILES_LIST, "r", encoding="UTF-8") as fh:
                for path in fh.read().splitlines():
                    names.append(os.path.basename(path))
        return names

    def delete_documents(self, filenames: List[str]) -> bool:
        """Remove files from the ingestion list by base name."""
        if not os.path.exists(INGESTED_CSV_FILES_LIST):
            return True
        drop = set(filenames)
        with open(INGESTED_CSV_FILES_LIST, "r", encoding="UTF-8") as fh:
            paths = [p for p in fh.read().splitlines() if p]
        kept = [p for p in paths if os.path.basename(p) not in drop]
        with open(INGESTED_CSV_FILES_LIST, "w", encoding="UTF-8") as fh:
            fh.write("".join(p + "\n" for p in kept))
        return True
