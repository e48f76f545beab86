"""Spec-document chatbot with a fact-check guardrail, a feedback log and a
summary memory (counterpart of the JAX repository's
experimental/oran_chatbot/), served over HTTP on the port's runtime."""
from generativeaiexamples_tpu_torch.experimental.oran_chatbot.feedback import FeedbackLog
from generativeaiexamples_tpu_torch.experimental.oran_chatbot.guardrails import (
    FactCheckResult,
    fact_check,
)
from generativeaiexamples_tpu_torch.experimental.oran_chatbot.memory import SummaryMemory

__all__ = ["fact_check", "FactCheckResult", "FeedbackLog", "SummaryMemory"]
