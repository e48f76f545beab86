"""Run provenance for measurement records and saved documents.

The port's copy of the JAX package's utils/provenance.py, with its names
and results: the git SHA and whether the tree was dirty, a fingerprint of
the configuration that produced a record, and whether the model served
random-init weights, so that tooling can refuse to compare numbers taken
under different conditions. Request snapshots (engine/request_snapshot.py)
and black-box bundles (utils/blackbox.py) carry these stamps.

Host only. Git is asked once per process for each query (a subprocess per
call would cost a drain that spools many snapshots); a checkout without
git gives None. ``GENAI_GIT_SHA`` and ``GENAI_GIT_DIRTY`` override both
and are read on every call.
"""
from __future__ import annotations

import functools
import hashlib
import json
import os
import pathlib
import subprocess
from typing import Any, Dict, Optional

_REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent


@functools.lru_cache(maxsize=4)
def _git(*args: str) -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", *args],
            cwd=str(_REPO_ROOT),
            capture_output=True,
            text=True,
            timeout=10,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return out.stdout.strip()


def git_sha() -> Optional[str]:
    """HEAD commit SHA, or None outside a git checkout."""
    env = os.environ.get("GENAI_GIT_SHA")
    if env:
        return env
    return _git("rev-parse", "HEAD") or None


def git_dirty() -> Optional[bool]:
    """True when the working tree differs from HEAD (uncommitted edits
    poison cross-run comparisons), None when git is unavailable."""
    env = os.environ.get("GENAI_GIT_DIRTY")
    if env is not None:
        return env.lower() not in ("0", "false", "no", "")
    status = _git("status", "--porcelain")
    if status is None:
        return None
    return bool(status)


def config_fingerprint(config: Any) -> Optional[str]:
    """Stable 12-hex digest of a configuration object: dataclasses,
    dicts, and anything JSON-serializable hash canonically (sorted
    keys); unknown leaves hash by repr. None stays None."""
    if config is None:
        return None

    def norm(obj: Any) -> Any:
        if hasattr(obj, "__dataclass_fields__"):
            return {
                name: norm(getattr(obj, name))
                for name in sorted(obj.__dataclass_fields__)
            }
        if isinstance(obj, dict):
            return {str(k): norm(v) for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))}
        if isinstance(obj, (list, tuple)):
            return [norm(v) for v in obj]
        if isinstance(obj, (str, int, float, bool)) or obj is None:
            return obj
        return repr(obj)

    blob = json.dumps(norm(config), sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:12]


def provenance(
    config: Any = None,
    weights_random_init: Optional[bool] = None,
    **extra: Any,
) -> Dict[str, Any]:
    """The provenance block a measurement record embeds. ``extra`` keys
    (e.g. ``kv_cache_dtype``) are stamped verbatim: serving-regime facts
    the fingerprint covers opaquely, surfaced so that a comparability
    refusal can say which knob differed."""
    out = {
        "git_sha": git_sha(),
        "git_dirty": git_dirty(),
        "config_fingerprint": config_fingerprint(config),
        "weights_random_init": weights_random_init,
    }
    out.update(extra)
    return out


def comparable(a: Dict[str, Any], b: Dict[str, Any]) -> list:
    """Reasons two provenance blocks must NOT be compared (empty list =
    comparable). Git SHAs may differ (tracking change across commits is
    the point), but the configuration and the weights regime must match.
    ``kv_cache_dtype`` is checked by name on top of the fingerprint, so
    that a bf16-vs-int8-vs-int4 refusal names it. A key absent on one
    side skips its check."""
    reasons = []
    for key in ("config_fingerprint", "weights_random_init",
                "kv_cache_dtype"):
        va, vb = a.get(key), b.get(key)
        if va is not None and vb is not None and va != vb:
            reasons.append(f"{key} differs: {va!r} vs {vb!r}")
    return reasons
