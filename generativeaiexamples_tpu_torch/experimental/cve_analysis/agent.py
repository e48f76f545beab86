"""The checklist agent: SBOM, version and code-search tools, then a verdict.

Counterpart of the JAX repository's experimental/cve_analysis/agent.py.
The model replies ``{"tool": <name>, "input": <arg>}`` to call a tool or
``{"final": <finding>}``; each observation is appended to the transcript
it sees next. A reply with no JSON object is taken as the finding; after
``max_steps`` tool calls the finding is the evidence gathered. Each step
asks the LLM greedily for at most 256 tokens, the verdict for 512.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional

from generativeaiexamples_tpu_torch.experimental.cve_analysis.tools import (
    CodeSearchTool,
    SBOMChecker,
    version_matches,
)

AGENT_PROMPT = (
    "You are a security analyst assessing one checklist item for a CVE in a "
    "container. Tools:\n"
    '- sbom_check: input a package name; returns its version in the container, or not-found\n'
    '- version_compare: input "installed_version, vulnerable_versions" (one version = '
    "vulnerable up to; two = inclusive range; more = exact set); returns whether the "
    "installed version is vulnerable\n"
    "- code_search: input a query; returns matching code/doc snippets\n"
    'Reply with ONLY JSON: {"tool": "<name>", "input": "<arg>"} to call a tool, or '
    '{"final": "<your finding for this checklist item>"} when done.'
)

VERDICT_PROMPT = (
    "You are a security analyst. Given the findings for each exploitability "
    "checklist item of a CVE, decide whether the container is exploitable. "
    'Reply with ONLY JSON: {"exploitable": true|false, "summary": "<one-paragraph justification>"}.'
)


@dataclasses.dataclass
class AgentTrace:
    item: str
    steps: List[Dict]
    finding: str


def _first_json(text: str) -> Optional[dict]:
    """The JSON object spanning the first '{' to the last '}', if it parses
    to a dict."""
    match = re.search(r"\{.*\}", text, re.DOTALL)
    if not match:
        return None
    try:
        obj = json.loads(match.group(0))
    except json.JSONDecodeError:
        return None
    return obj if isinstance(obj, dict) else None


class ChecklistAgent:
    def __init__(
        self,
        llm,
        sbom: Optional[SBOMChecker] = None,
        code_search: Optional[CodeSearchTool] = None,
        max_steps: int = 4,
    ):
        self.llm = llm
        self.sbom = sbom
        self.code_search = code_search
        self.max_steps = max_steps

    def _call_tool(self, name: str, arg: str) -> str:
        if name == "sbom_check":
            if self.sbom is None:
                return "No SBOM available."
            return self.sbom.describe(arg)
        if name == "version_compare":
            parts = [p.strip() for p in arg.split(",")]
            if len(parts) < 2:
                return "version_compare needs 'installed, vulnerable_versions'."
            installed, vulnerable = parts[0], ",".join(parts[1:])
            hit = version_matches(installed, vulnerable)
            return (
                f"Installed version {installed} IS within the vulnerable set ({vulnerable})."
                if hit
                else f"Installed version {installed} is NOT in the vulnerable set ({vulnerable})."
            )
        if name == "code_search":
            if self.code_search is None:
                return "No code index available."
            return self.code_search.search(arg)
        return f"Unknown tool {name!r}."

    def run_item(self, cve_info: str, item: str) -> AgentTrace:
        transcript = f"CVE details: {cve_info}\nChecklist item: {item}"
        steps: List[Dict] = []
        for _ in range(self.max_steps):
            raw = self.llm.complete(
                [("system", AGENT_PROMPT), ("user", transcript)],
                temperature=0.0,
                max_tokens=256,
            )
            obj = _first_json(raw)
            if obj is None:  # no JSON: the text is the finding
                return AgentTrace(item=item, steps=steps, finding=raw.strip())
            if "final" in obj:
                return AgentTrace(item=item, steps=steps, finding=str(obj["final"]))
            tool = str(obj.get("tool", ""))
            arg = str(obj.get("input", ""))
            observation = self._call_tool(tool, arg)
            steps.append({"tool": tool, "input": arg, "observation": observation})
            transcript += f"\nTool {tool}({arg!r}) -> {observation}"
        return AgentTrace(
            item=item, steps=steps, finding="Step limit reached; evidence: "
            + "; ".join(s["observation"] for s in steps)
        )

    def verdict(self, cve_info: str, traces: List[AgentTrace]) -> Dict:
        findings = "\n".join(f"- {t.item}: {t.finding}" for t in traces)
        raw = self.llm.complete(
            [("system", VERDICT_PROMPT), ("user", f"CVE: {cve_info}\nFindings:\n{findings}")],
            temperature=0.0,
            max_tokens=512,
        )
        obj = _first_json(raw) or {}
        return {
            "exploitable": bool(obj.get("exploitable", False)),
            "summary": str(obj.get("summary", raw.strip())),
        }
