"""On-demand ``torch.profiler`` capture + dispatch trace annotations.

Counterpart of generativeaiexamples_tpu/utils/profiling.py, which drives
``jax.profiler``. The servers expose ``POST /internal/profile/start`` /
``/stop`` (handlers in ``server/observability.py``), which call
:func:`start_profile` / :func:`stop_profile` here, so an operator can
bracket a live traffic window and pull the trace from
``PROFILE_LOG_DIR`` with no restart.

Gated on ``ENABLE_PROFILING`` with JAX's status codes: 403 when disabled,
501 when no profiler is available, 409 when a capture is already running
(start) or none is (stop), 500 when the profiler fails. One profiler
session a process: a script's own traced windows (utils/device_trace.py
``DeviceWindow``) must not overlap a capture.

A capture records CPU (of every thread, where PyTorch offers it) and (on a
CUDA machine) CUDA activity, on a thread of its own that makes every
profiler call (Kineto must start and stop on one thread; each HTTP
request has its own). At stop that thread
synchronizes the device (never the engine's dispatch thread does) so every
kernel launched in the window lands in the trace, writes the Chrome trace
under the log dir, and the answer
carries the device-track reading (utils/device_trace.py ``analyze``):
busy time, wall time and idle share, per-kernel time, and whether the
trace holds every port kernel the wrappers launched over the window
(``complete``; busy time and idle share are None when it does not).

:class:`TraceWindow` is the same session around a block of a script's
own (tools/profile_decode.py), ungated by ``ENABLE_PROFILING``: it keeps
the window's device events beside their reading, and writes the Chrome
trace only where asked.

:func:`annotation_scope` returns ``torch.profiler.record_function`` so
the engine labels its prefill-wave, chunk, decode-block and verify
dispatches in the trace; when profiling is disabled it returns a no-op
factory resolved once at engine init.
"""
from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import threading
import time
from typing import Any, Callable, ContextManager, Dict, List, Optional, Tuple

from generativeaiexamples_tpu_torch.utils import device_trace

logger = logging.getLogger(__name__)

# the log dir's name under the temporary directory (TMPDIR) when
# PROFILE_LOG_DIR is unset
DEFAULT_PROFILE_DIR = "genai_torch_profiles"


def profiling_enabled() -> bool:
    return os.environ.get("ENABLE_PROFILING", "").lower() in ("true", "1", "yes")


def default_log_dir() -> str:
    return os.environ.get("PROFILE_LOG_DIR") or os.path.join(tempfile.gettempdir(),
                                                             DEFAULT_PROFILE_DIR)


def _profiler():
    """The torch.profiler module, or None when unavailable."""
    try:
        import torch.profiler as profiler

        profiler.profile, profiler.record_function  # noqa: B018
        return profiler
    except Exception:  # noqa: BLE001 - any import/attr failure means no profiler
        return None


def _all_threads() -> Dict[str, Any]:
    """The profiler option that records the CPU ops of every thread (the
    engine's labels are on its dispatch thread, not the session's), where
    this PyTorch has it; else none (only the session's thread)."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


def _cuda() -> bool:
    import torch

    return torch.cuda.is_available()


# --------------------------------------------------------------------------- #
# Capture session (process-wide: one profiler session at a time). The
# profiler must start and stop on one thread (Kineto refuses, and can
# crash, otherwise), and each HTTP request runs on a thread of its own: a
# session owns a thread ("torch-profiler") that makes every profiler call.

_LOCK = threading.Lock()
_ACTIVE: Optional["_Session"] = None  # guarded by _LOCK


class _Session:
    def __init__(self, profiler, log_dir: Optional[str]):
        self.log_dir = log_dir  # None: no Chrome trace written
        self.started = time.time()
        self.error: Optional[BaseException] = None
        self.body: Optional[Dict[str, Any]] = None
        self.events: List[device_trace.Event] = []
        self._profiler = profiler
        self._launched: Dict[str, int] = {}
        self._t0 = 0.0
        self._ready, self._stop, self._done = (threading.Event(), threading.Event(),
                                               threading.Event())
        self._thread = threading.Thread(target=self._run, name="torch-profiler", daemon=True)

    def start(self) -> None:
        """Start the profiler on the session's thread; raises what it
        raised."""
        self._thread.start()
        self._ready.wait()
        if self.error is not None:
            raise self.error

    def stop(self, timeout: float = 600.0) -> Dict[str, Any]:
        """Stop it there: the window's launches counted and the device
        synchronized first (every counted kernel lands in the trace), the
        Chrome trace written, the device track read. Raises what failed."""
        self._stop.set()
        if not self._done.wait(timeout):
            raise TimeoutError(f"the profiler did not stop within {timeout:.0f} s")
        if self.error is not None:
            raise self.error
        return self.body

    def _run(self) -> None:
        try:
            activities = [self._profiler.ProfilerActivity.CPU]
            if _cuda():
                activities.append(self._profiler.ProfilerActivity.CUDA)
            prof = self._profiler.profile(activities=activities, **_all_threads())
            prof.start()
        except Exception as exc:  # noqa: BLE001 - reported to start()
            self.error = exc
            self._ready.set()
            return
        if _cuda():
            time.sleep(device_trace.START_GUARD_S)
        # counted from here: every kernel launched after this is in the trace
        self._launched = device_trace.kernel_counts()
        self._t0 = time.perf_counter()
        self._ready.set()
        self._stop.wait()
        try:
            # counted up to here, then synchronized: every kernel counted has
            # run before the trace stops (a dispatch thread launches on
            # while the synchronize waits; those launches may be cut off)
            launched = {k: n - self._launched[k]
                        for k, n in device_trace.kernel_counts().items()}
            if _cuda():
                import torch

                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - self._t0) * 1e3
            prof.stop()
            self.events = device_trace.profile_events(prof)
            path = None
            if self.log_dir is not None:
                path = os.path.join(self.log_dir,
                                    f"trace-{int(self.started * 1000)}-{os.getpid()}.json")
                prof.export_chrome_trace(path)
            self.body = {"trace": path, **device_trace.analyze(self.events, launched, wall_ms)}
        except Exception as exc:  # noqa: BLE001 - reported to stop()
            self.error = exc
        finally:
            self._done.set()


def start_profile(log_dir: Optional[str] = None) -> Tuple[int, Dict[str, Any]]:
    """Begin a profiler capture. Returns (http_status, json_body)."""
    global _ACTIVE
    if not profiling_enabled():
        return 403, {"error": "profiling disabled; set ENABLE_PROFILING=true to enable"}
    profiler = _profiler()
    if profiler is None:
        return 501, {"error": "torch profiler unavailable in this environment"}
    log_dir = log_dir or default_log_dir()
    with _LOCK:
        if _ACTIVE is not None:
            return 409, {"error": "profile capture already running",
                         "log_dir": _ACTIVE.log_dir}
        try:
            os.makedirs(log_dir, exist_ok=True)
            session = _Session(profiler, log_dir)
            session.start()
        except Exception as exc:  # noqa: BLE001 - capture must not kill serving
            logger.warning("profiler start failed: %s", exc)
            return 500, {"error": f"profiler start failed: {exc}"}
        _ACTIVE = session
    logger.info("torch profiler capture started -> %s", log_dir)
    return 200, {"ok": True, "log_dir": log_dir}


def stop_profile() -> Tuple[int, Dict[str, Any]]:
    """End the active capture, write its Chrome trace and read its device
    track. Returns (http_status, json_body). A failed stop ends the
    session (its thread is done), where JAX keeps it for a retry."""
    global _ACTIVE
    if not profiling_enabled():
        return 403, {"error": "profiling disabled; set ENABLE_PROFILING=true to enable"}
    if _profiler() is None:
        return 501, {"error": "torch profiler unavailable in this environment"}
    with _LOCK:
        if _ACTIVE is None:
            return 409, {"error": "no profile capture running"}
        session, _ACTIVE = _ACTIVE, None
        try:
            analysis = session.stop()
        except Exception as exc:  # noqa: BLE001
            logger.warning("profiler stop failed: %s", exc)
            return 500, {"error": f"profiler stop failed: {exc}", "log_dir": session.log_dir}
    duration = round(time.time() - session.started, 3)
    body: Dict[str, Any] = {"ok": True, "log_dir": session.log_dir, "duration_s": duration}
    body.update(analysis)
    logger.info("torch profiler capture stopped (%.3fs) -> %s", duration, analysis["trace"])
    return 200, body


def capture_active() -> bool:
    with _LOCK:
        return _ACTIVE is not None


class TraceWindow:
    """One capture around a block: ``with TraceWindow() as win: ...``,
    then ``win.result`` (the :func:`device_trace.analyze` reading, with
    ``trace``: the Chrome trace's path or None) and ``win.events`` (the
    window's device events). ``log_dir`` writes the Chrome trace there.
    Holds the process's one capture slot: raises where an HTTP capture is
    running."""

    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        self.result: Optional[Dict[str, Any]] = None
        self.events: List[device_trace.Event] = []

    def __enter__(self):
        global _ACTIVE
        profiler = _profiler()
        if profiler is None:
            raise RuntimeError("torch profiler unavailable in this environment")
        if self.log_dir is not None:
            os.makedirs(self.log_dir, exist_ok=True)
        with _LOCK:
            if _ACTIVE is not None:
                raise RuntimeError("a profile capture is already running")
            self._session = _Session(profiler, self.log_dir)
            self._session.start()
            _ACTIVE = self._session
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        with _LOCK:
            _ACTIVE = None
        self.result = self._session.stop()
        self.events = self._session.events
        return False


# --------------------------------------------------------------------------- #
# Dispatch annotations


def annotation_scope() -> Callable[[str], ContextManager]:
    """Factory for dispatch-labelling scopes, resolved ONCE (engine init):
    ``torch.profiler.record_function`` when ENABLE_PROFILING is set, else a
    nullcontext factory, so the dispatch loop pays nothing with profiling
    off."""
    if profiling_enabled():
        profiler = _profiler()
        if profiler is not None:
            return profiler.record_function
        logger.warning("ENABLE_PROFILING set but torch.profiler is unavailable; "
                       "dispatch annotations disabled")
    return lambda name: contextlib.nullcontext()
