"""The query-decomposition agent chain (``query_decomposition``,
``query_decomposition_rag``): the port's copy of the JAX package's
generativeaiexamples_tpu/chains/query_decomposition.py, an explicit agent
loop with the reference's protocol:

- the decomposition prompt asks the LLM for JSON ``{"Tool_Request": ...,
  "Generated Sub Questions": [...]}`` naming the Search or Math tool, or
  Nil;
- a ``Ledger`` gathers sub-questions and their answers, at most
  ``MAX_RECURSIONS`` rounds;
- Search retrieves for each sub-question without the score threshold and
  asks the LLM to extract its answer; Math asks for two variables and an
  operator as JSON and applies ``_SAFE_OPS`` (no ``eval``), falling back
  to asking the LLM;
- a reply that is not JSON ends the loop; with no sub-question answered,
  the question itself is searched;
- the final "Question/Sub Questions and Answers/Final Answer:" prompt is
  streamed to the user.

Every LLM call goes through ``LLMBackend.complete`` or ``stream_chat``.
"""
from __future__ import annotations

import json
import logging
import re
from typing import Any, Dict, Generator, List, Optional

from generativeaiexamples_tpu_torch.chains import runtime
from generativeaiexamples_tpu_torch.chains.base import BaseExample
from generativeaiexamples_tpu_torch.chains.developer_rag import NO_CONTEXT_MSG
from generativeaiexamples_tpu_torch.config import get_config

logger = logging.getLogger(__name__)

COLLECTION = "default"
MAX_RECURSIONS = 3

DECOMPOSITION_TEMPLATE = """Your task is to answer questions. If you cannot answer the question, you can request use for a tool and break the question into specific sub questions. Fill with Nil where no action is required. You should only return a JSON containing the tool and the generated sub questions. Consider the contextual information and only ask for information that you do not already have. Do not return any other explanations or text. The output should be a simple JSON structure! You are given two tools:
- Search
- Math
Search tool quickly finds and retrieves relevant answers from a given context, providing accurate and precise information to meet search needs.
Math tool performs essential operations, including multiplication, addition, subtraction, division, and greater than or less than comparisons, providing accurate results with ease. Utilize math tool when asked to find sum, difference of values.
Do not pass sub questions to any tool if they already have an answer in the Contextual Information.
If you have all the information needed to answer the question, mark the Tool_Request as Nil.

Contextual Information:
{context}

Question:
{question}

{{"Tool_Request": "<Fill>", "Generated Sub Questions": [<Fill>]}}
"""

MATH_TOOL_PROMPT = """Your task is to identify 2 variables and an operation from given questions. If you cannot answer the question, you can simply return "Not Possible". You should only return a JSON containing the `IsPossible`, `variable1`, `variable2`, and `operation`. Do not return any other explanations or text. The output should be a simple JSON structure!
 You are given two options for `IsPossible`:
- Possible
- Not Possible
 `variable1` and `variable2` should be real floating point numbers.
 You are given four options for `operation symbols`:
- '+' (addition)
- '-' (subtraction)
- '*' (multiplication)
- '/' (division)
- '=' (equal to)
- '>' (greater than)
- '<' (less than)
- '>=' (greater than or equal to)
- '<=' (less than or equal to)
    Only return the symbols for the specified operations and nothing else.
"""

_SAFE_OPS = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "=": lambda a, b: a == b,
    ">": lambda a, b: a > b,
    "<": lambda a, b: a < b,
    ">=": lambda a, b: a >= b,
    "<=": lambda a, b: a <= b,
}


class Ledger:
    """The state of one decomposition: sub-questions, their answers, the
    round count and whether the agent is done."""

    def __init__(self) -> None:
        self.question_trace: List[str] = []
        self.answer_trace: List[str] = []
        self.trace = 0
        self.done = False


def fetch_context(ledger: Ledger) -> str:
    """The ledger's sub-questions and answers as the prompts' context."""
    context = ""
    for q, a in zip(ledger.question_trace, ledger.answer_trace):
        context += "Sub-Question: " + q + "\nSub-Answer: " + a + "\n"
    return context


def _parse_json_block(text: str) -> Optional[Dict[str, Any]]:
    """The first JSON object of an LLM reply, or None."""
    match = re.search(r"\{.*\}", text, re.DOTALL)
    if not match:
        return None
    try:
        return json.loads(match.group(0))
    except json.JSONDecodeError:
        return None


class QueryDecompositionChatbot(BaseExample):
    def __init__(self) -> None:
        self.ledger = Ledger()
        self.kwargs: Dict[str, Any] = {}

    def ingest_docs(self, filepath: str, filename: str) -> None:
        try:
            runtime.ingest_file(filepath, filename, collection=COLLECTION)
        except Exception as exc:
            logger.error("Failed to ingest %s: %s", filename, exc)
            raise ValueError(
                "Failed to upload document. Please upload an unstructured text document."
            ) from exc

    def llm_chain(self, query: str, chat_history: List[Any], **kwargs: Any
                  ) -> Generator[str, None, None]:
        config = get_config()
        messages = ([("system", config.prompts.chat_template)]
                    + runtime.history_to_messages(chat_history) + [("user", query)])
        return runtime.get_llm(config).stream_chat(messages, **runtime.llm_settings(kwargs))

    def rag_chain(self, query: str, chat_history: List[Any], **kwargs: Any
                  ) -> Generator[str, None, None]:
        try:
            final_context = self.run_agent(query, **kwargs)
            if not final_context:
                logger.warning("Retrieval failed to get any relevant context")
                return iter([NO_CONTEXT_MSG])
            logger.info("Final Answer from agent: %s", final_context)
            return runtime.get_llm().stream_chat(
                [("user", final_context)], **runtime.llm_settings(kwargs))
        except ValueError as exc:
            logger.warning("Failed to get response because %s", exc)
            return iter(["I can't find an answer for that."])

    # -- the agent loop ------------------------------------------------- #
    def run_agent(self, question: str, **kwargs: Any) -> str:
        """Decompose, run the tools, and return the final prompt ("" when
        nothing was found)."""
        self.ledger = Ledger()
        self.kwargs = runtime.llm_settings(kwargs)
        llm = runtime.get_llm()

        while not self.ledger.done and self.ledger.trace < MAX_RECURSIONS:
            self.ledger.trace += 1
            prompt = DECOMPOSITION_TEMPLATE.format(
                context=fetch_context(self.ledger), question=question)
            reply = llm.complete([("user", prompt)], **self.kwargs)
            parsed = _parse_json_block(reply)
            if parsed is None:
                logger.warning("Agent reply was not valid JSON: %r", reply[:200])
                break
            tool = str(parsed.get("Tool_Request", "Nil")).strip().lower()
            sub_questions = parsed.get("Generated Sub Questions") or []
            if isinstance(sub_questions, str):
                sub_questions = [sub_questions]
            if tool == "search" and sub_questions:
                self.search(sub_questions)
            elif tool == "math" and sub_questions:
                self.math(sub_questions)
            else:  # Nil or an unknown tool: done
                self.ledger.done = True

        if not self.ledger.question_trace:
            # no decomposition happened: search the question itself
            self.search([question])
            if not self.ledger.answer_trace:
                return ""

        prompt = "Question: " + question + "\n\n"
        prompt += "Sub Questions and Answers\n"
        for q, a in zip(self.ledger.question_trace, self.ledger.answer_trace):
            prompt += "Sub Question: " + str(q) + "\n"
            prompt += "Sub Answer: " + str(a) + "\n"
        prompt += "\nFinal Answer: "
        return prompt

    def retriever(self, query: str) -> List[str]:
        """The texts of an unfiltered retrieval (score threshold 0)."""
        hits = runtime.retrieve(query, score_threshold=0.0, collection=COLLECTION)
        return [h.chunk.text for h in hits]

    def extract_answer(self, chunks: List[str], question: str) -> str:
        prompt = (
            "Below is a Question and set of Passages that may or may not be relevant. "
            "Your task is to Extract the answer for question using only the information "
            "available in the passages. Be as concise as possible and only include the "
            "answer if present. Do not infer or process the passage in any other way\n\n"
        )
        prompt += "Question: " + question + "\n\n"
        for idx, chunk in enumerate(chunks):
            prompt += f"Passage {idx + 1}:\n" + chunk + "\n"
        return runtime.get_llm().complete([("user", prompt)], **self.kwargs)

    def search(self, sub_questions: List[str]) -> None:
        logger.info("Entering search with subquestions: %s", sub_questions)
        for sub_question in sub_questions:
            chunks = self.retriever(str(sub_question))
            sub_answer = self.extract_answer(chunks, str(sub_question)) if chunks else ""
            self.ledger.question_trace.append(str(sub_question))
            self.ledger.answer_trace.append(sub_answer)

    def math(self, sub_questions: List[str]) -> None:
        """The first sub-question's two variables and operator as JSON,
        applied through ``_SAFE_OPS``; any failure asks the LLM to solve
        it instead. Ends the agent loop."""
        llm = runtime.get_llm()
        question = str(sub_questions[0])
        try:
            prompt = f"{MATH_TOOL_PROMPT}\nQuestion: {question}"
            prompt += f"Context:\n{fetch_context(self.ledger)}\n"
            reply = llm.complete([("user", prompt)], **self.kwargs)
            parsed = _parse_json_block(reply) or {}
            if str(parsed.get("IsPossible", "")).lower().startswith("not"):
                raise ValueError("math not possible")
            v1 = parsed["variable1"]
            v2 = parsed["variable2"]
            op = parsed["operation"]
            v1 = float(v1[0] if isinstance(v1, list) else v1)
            v2 = float(v2[0] if isinstance(v2, list) else v2)
            op = str(op[0] if isinstance(op, list) else op)
            result = _SAFE_OPS[op](v1, v2)
            final_sub_answer = f"{v1}{op}{v2}={result}"
        except Exception:  # noqa: BLE001 - the LLM fallback
            prompt = "Solve this mathematical question:\nQuestion: " + question
            prompt += f"Context:\n{fetch_context(self.ledger)}\n"
            prompt += "Be concise and only return the answer."
            final_sub_answer = llm.complete([("user", prompt)], **self.kwargs)

        self.ledger.question_trace.append(question)
        self.ledger.answer_trace.append(final_sub_answer)
        self.ledger.done = True

    # -- document management -------------------------------------------- #
    def document_search(self, content: str, num_docs: int) -> List[Dict[str, Any]]:
        try:
            hits = runtime.retrieve(content, top_k=num_docs, score_threshold=0.0,
                                    collection=COLLECTION)
            return [{"source": h.chunk.source, "content": h.chunk.text, "score": h.score}
                    for h in hits]
        except Exception as exc:  # noqa: BLE001
            logger.error("Error from document_search: %s", exc)
            return []

    def get_documents(self) -> List[str]:
        return runtime.get_vector_store(COLLECTION).sources()

    def delete_documents(self, filenames: List[str]) -> bool:
        return runtime.delete_documents(filenames, COLLECTION)
