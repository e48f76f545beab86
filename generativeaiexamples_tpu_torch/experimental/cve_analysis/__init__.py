"""CVE exploitability triage (counterpart of the JAX repository's
experimental/cve_analysis/): for each CVE the LLM writes a checklist, a
tool-using agent works through it (SBOM lookup, version comparison, code
search over a port store) and the LLM gives a verdict; CVEs run in
parallel threads against the port's LLM backend."""
from generativeaiexamples_tpu_torch.experimental.cve_analysis.checklist import (
    generate_checklist,
)
from generativeaiexamples_tpu_torch.experimental.cve_analysis.pipeline import (
    CVEPipeline,
    CVEVerdict,
)
from generativeaiexamples_tpu_torch.experimental.cve_analysis.tools import (
    SBOMChecker,
    version_in_range,
)

__all__ = ["CVEPipeline", "CVEVerdict", "SBOMChecker", "version_in_range", "generate_checklist"]
