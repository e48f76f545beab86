"""The CVE agent's tools: version comparison, an SBOM lookup, code search.

Counterpart of the JAX repository's experimental/cve_analysis/tools.py:

- ``compare_versions`` tokenizes a version into numeric runs (compared as
  numbers) and alphabetic runs (compared lowercased, below any number),
  with a terminator between the two, so ``1.0a < 1.0 < 1.0.1``; Debian
  epochs and suffixes compare without special cases. ``version_matches``
  reads one version as "vulnerable up to", two as an inclusive range and
  more as an exact set;
- ``SBOMChecker``: a package -> version map from a CSV (``name`` or
  ``package``/``package name`` columns, ``version`` or ``package
  version``), looked up exactly, then by substring either way;
- ``CodeSearchTool``: any port store searched with the embedder's
  ``embed_query`` (the in-process encoder and store run on the card), the
  top hits' first 400 characters joined by ``\\n---\\n``.
"""
from __future__ import annotations

import csv
import re
from typing import Dict, List, Optional, Tuple


def _version_key(version: str) -> Tuple:
    """A comparable tuple: numeric runs as (2, int), alphabetic runs as
    (0, lowercased), then the terminator (1,)."""
    tokens = re.findall(r"\d+|[a-zA-Z]+", str(version).strip())
    key: List[Tuple] = []
    for tok in tokens:
        if tok.isdigit():
            key.append((2, int(tok)))
        else:
            key.append((0, tok.lower()))
    key.append((1,))
    return tuple(key)


def compare_versions(a: str, b: str) -> int:
    ka, kb = _version_key(a), _version_key(b)
    return (ka > kb) - (ka < kb)


def version_at_most(software_version: str, vulnerable_up_to: str) -> bool:
    """True if software_version <= vulnerable_up_to."""
    return compare_versions(software_version, vulnerable_up_to) <= 0


def version_in_range(software_version: str, lower: str, upper: str) -> bool:
    """True if lower <= software_version <= upper (inclusive)."""
    return (
        compare_versions(software_version, lower) >= 0
        and compare_versions(software_version, upper) <= 0
    )


def version_matches(software_version: str, vulnerable_versions: str) -> bool:
    """'x' (at most x), 'lo,hi' (inclusive range), 'a,b,c' (any exact)."""
    parts = [p.strip() for p in str(vulnerable_versions).split(",") if p.strip()]
    if not parts:
        return False
    if len(parts) == 1:
        return version_at_most(software_version, parts[0])
    if len(parts) == 2:
        return version_in_range(software_version, parts[0], parts[1])
    return any(compare_versions(software_version, p) == 0 for p in parts)


class SBOMChecker:
    """Package -> version lookup over a software bill of materials."""

    def __init__(self, sbom_map: Dict[str, str]):
        self.sbom_map = {str(k).lower(): str(v) for k, v in sbom_map.items()}

    @staticmethod
    def from_csv(file_path: str, name_field: str = "name",
                 version_field: str = "version") -> "SBOMChecker":
        sbom: Dict[str, str] = {}
        with open(file_path, "r", encoding="utf-8", errors="replace") as fh:
            for row in csv.DictReader(fh):
                row = {k.strip().lower(): (v or "").strip() for k, v in row.items() if k}
                name = row.get(name_field) or row.get("package") or row.get("package name")
                version = row.get(version_field) or row.get("package version") or ""
                if name:
                    sbom[name.lower()] = version
        return SBOMChecker(sbom)

    def check(self, package_name: str) -> Optional[str]:
        """The version if the package is present (exact, then substring)."""
        name = package_name.strip().lower()
        if name in self.sbom_map:
            return self.sbom_map[name]
        for pkg, version in self.sbom_map.items():
            if name and (name in pkg or pkg in name):
                return version
        return None

    def describe(self, package_name: str) -> str:
        version = self.check(package_name)
        if version is None:
            return f"Package '{package_name}' not found in the SBOM."
        return f"Package '{package_name}' is present at version {version}."


class CodeSearchTool:
    """Search over an ingested code or document collection."""

    def __init__(self, embedder, store, top_k: int = 4):
        self.embedder = embedder
        self.store = store
        self.top_k = top_k

    def search(self, query: str) -> str:
        hits = self.store.search(self.embedder.embed_query(query), self.top_k)
        if not hits:
            return "No matching code found."
        return "\n---\n".join(h.chunk.text[:400] for h in hits)
