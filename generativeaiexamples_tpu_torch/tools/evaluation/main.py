"""Evaluation CLI: generate synthetic QnA -> answer through a chain server
-> score.

Counterpart of the JAX repository's tools/evaluation/main.py, with its
three subcommands and flags:

  python -m generativeaiexamples_tpu_torch.tools.evaluation.main generate-data \\
      --docs a.pdf b.txt --output qna.json
  python -m generativeaiexamples_tpu_torch.tools.evaluation.main generate-answers \\
      --qna qna.json --server http://localhost:8081 --docs a.pdf --output eval.json
  python -m generativeaiexamples_tpu_torch.tools.evaluation.main evaluate \\
      --eval eval.json --output results.json

``generate-data`` and ``evaluate`` run the runtime's LLM (and, for
answer similarity, its embedder) on the card; with no card they raise
unless ``--device cpu`` asks for the CPU. ``generate-answers`` is an HTTP
client of a chain server and runs no model.
"""
from __future__ import annotations

import argparse
import json
import sys


def _use_device(device) -> None:
    from generativeaiexamples_tpu_torch.chains import runtime

    if device is not None:
        runtime.set_device(device)
    runtime.check_device("the evaluation harness")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="RAG evaluation harness")
    sub = parser.add_subparsers(dest="command", required=True)
    device_help = "device of the LLM and the embedder (default: the card)"

    gen = sub.add_parser("generate-data", help="synthesize QnA pairs from documents")
    gen.add_argument("--docs", nargs="+", required=True)
    gen.add_argument("--output", default="qna.json")
    gen.add_argument("--pairs-per-chunk", type=int, default=2)
    gen.add_argument("--max-chunks", type=int, default=None)
    gen.add_argument("--device", default=None, help=device_help)

    ans = sub.add_parser("generate-answers", help="drive a running chain-server")
    ans.add_argument("--qna", required=True)
    ans.add_argument("--server", default="http://localhost:8081")
    ans.add_argument("--docs", nargs="*", default=[])
    ans.add_argument("--output", default="eval.json")
    ans.add_argument("--top-k", type=int, default=4)
    ans.add_argument("--no-knowledge-base", action="store_true")

    ev = sub.add_parser("evaluate", help="score generated answers")
    ev.add_argument("--eval", required=True)
    ev.add_argument("--output", default="results.json")
    ev.add_argument("--judge", choices=["ragas", "likert", "both"], default="both")
    ev.add_argument("--device", default=None, help=device_help)

    args = parser.parse_args(argv)

    if args.command == "generate-data":
        from generativeaiexamples_tpu_torch.tools.evaluation.synthetic_data_generator import (
            generate_synthetic_data,
        )

        _use_device(args.device)
        qna = generate_synthetic_data(
            args.docs,
            args.output,
            pairs_per_chunk=args.pairs_per_chunk,
            max_chunks=args.max_chunks,
        )
        print(f"generated {len(qna)} QnA pairs -> {args.output}")
    elif args.command == "generate-answers":
        from generativeaiexamples_tpu_torch.tools.evaluation.answer_generator import (
            generate_answers,
        )

        with open(args.qna) as fh:
            qna = json.load(fh)
        rows = generate_answers(
            qna,
            args.output,
            server_url=args.server,
            docs=args.docs,
            top_k=args.top_k,
            use_knowledge_base=not args.no_knowledge_base,
        )
        print(f"generated {len(rows)} answers -> {args.output}")
    elif args.command == "evaluate":
        from generativeaiexamples_tpu_torch.tools.evaluation.evaluator import (
            eval_llm_judge,
            eval_ragas,
            write_results,
        )

        _use_device(args.device)
        with open(args.eval) as fh:
            rows = json.load(fh)
        results = {}
        if args.judge in ("ragas", "both"):
            results.update(eval_ragas(rows))
        if args.judge in ("likert", "both"):
            results.update(eval_llm_judge(rows))
        write_results(results, args.output)
        print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
