"""CVE triage: each CVE through checklist -> agent -> verdict, CVEs in parallel.

Counterpart of the JAX repository's experimental/cve_analysis/pipeline.py.
Each CVE is an asyncio task, at most ``max_concurrency`` at once (a
semaphore), whose checklist (cut to ``max_checklist_items``), per-item
agent runs and verdict run in the default executor's threads against one
LLM backend: with the runtime's, up to ``max_concurrency`` threads submit
to the one engine on the card at once.

    python -m generativeaiexamples_tpu_torch.experimental.cve_analysis.pipeline \\
        --cves cves.jsonl --sbom sbom.csv --code-collection code --out verdicts.jsonl

The CLI builds the runtime's LLM (and, with ``--code-collection``, its
embedder and store) on the card; with no card it raises unless
``--device cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse
import asyncio
import csv
import dataclasses
import json
import sys
from typing import Dict, List, Optional

from generativeaiexamples_tpu_torch.experimental.cve_analysis.agent import (
    AgentTrace,
    ChecklistAgent,
)
from generativeaiexamples_tpu_torch.experimental.cve_analysis.checklist import (
    generate_checklist,
)
from generativeaiexamples_tpu_torch.experimental.cve_analysis.tools import (
    CodeSearchTool,
    SBOMChecker,
)


@dataclasses.dataclass
class CVEVerdict:
    cve_info: str
    checklist: List[str]
    traces: List[AgentTrace]
    exploitable: bool
    summary: str

    def as_dict(self) -> Dict:
        return {
            "cve_info": self.cve_info,
            "checklist": self.checklist,
            "findings": [
                {"item": t.item, "finding": t.finding, "steps": t.steps} for t in self.traces
            ],
            "exploitable": self.exploitable,
            "summary": self.summary,
        }


class CVEPipeline:
    def __init__(
        self,
        llm,
        sbom: Optional[SBOMChecker] = None,
        code_search: Optional[CodeSearchTool] = None,
        max_concurrency: int = 4,
        max_checklist_items: int = 8,
    ):
        self.llm = llm
        self.agent = ChecklistAgent(llm, sbom=sbom, code_search=code_search)
        self.max_concurrency = max_concurrency
        self.max_checklist_items = max_checklist_items

    def _analyze_one(self, cve_info: str) -> CVEVerdict:
        checklist = generate_checklist(self.llm, cve_info)[: self.max_checklist_items]
        traces = [self.agent.run_item(cve_info, item) for item in checklist]
        verdict = self.agent.verdict(cve_info, traces)
        return CVEVerdict(
            cve_info=cve_info,
            checklist=checklist,
            traces=traces,
            exploitable=verdict["exploitable"],
            summary=verdict["summary"],
        )

    async def run(self, cve_infos: List[str]) -> List[CVEVerdict]:
        loop = asyncio.get_running_loop()
        sem = asyncio.Semaphore(self.max_concurrency)

        async def bounded(info: str) -> CVEVerdict:
            async with sem:
                return await loop.run_in_executor(None, self._analyze_one, info)

        return list(await asyncio.gather(*(bounded(i) for i in cve_infos)))

    def run_sync(self, cve_infos: List[str]) -> List[CVEVerdict]:
        return asyncio.run(self.run(cve_infos))


def _load_cves(path: str) -> List[str]:
    """CVE descriptions: a CSV's ``cve_info``/``description`` column
    (``.csv``), else JSONL rows with such a field, a line that is no JSON
    object being the description itself."""
    out: List[str] = []
    if path.endswith(".csv"):
        with open(path, "r", encoding="utf-8", errors="replace") as fh:
            for row in csv.DictReader(fh):
                row = {k.strip().lower(): v for k, v in row.items() if k}
                info = row.get("cve_info") or row.get("description") or ""
                if info.strip():
                    out.append(info.strip())
        return out
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
                info = obj.get("cve_info") or obj.get("description") or ""
            except (json.JSONDecodeError, AttributeError):
                info = line
            if info.strip():
                out.append(info.strip())
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="CVE exploitability triage")
    parser.add_argument("--cves", required=True, help="JSONL/CSV/plain-text CVE descriptions")
    parser.add_argument("--sbom", help="SBOM CSV (package name/version columns)")
    parser.add_argument("--code-collection", help="vector-store collection to code-search")
    parser.add_argument("--out", help="write verdicts JSONL here (default stdout)")
    parser.add_argument("--concurrency", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="device of the LLM, the embedder and the store (default: the card)")
    args = parser.parse_args(argv)

    from generativeaiexamples_tpu_torch.chains import runtime

    if args.device is not None:
        runtime.set_device(args.device)
    runtime.check_device("the CVE pipeline")

    sbom = SBOMChecker.from_csv(args.sbom) if args.sbom else None
    code_search = None
    if args.code_collection:
        code_search = CodeSearchTool(runtime.get_embedder(),
                                     runtime.get_vector_store(args.code_collection))

    pipeline = CVEPipeline(
        runtime.get_llm(), sbom=sbom, code_search=code_search, max_concurrency=args.concurrency
    )
    verdicts = pipeline.run_sync(_load_cves(args.cves))

    sink = open(args.out, "w", encoding="utf-8") if args.out else sys.stdout
    try:
        for verdict in verdicts:
            sink.write(json.dumps(verdict.as_dict()) + "\n")
    finally:
        if args.out:
            sink.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
