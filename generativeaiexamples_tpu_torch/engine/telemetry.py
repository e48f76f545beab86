"""Live engine-utilization telemetry: the on-line version of bench.py's
offline roofline/MFU lines.

Counterpart of generativeaiexamples_tpu/engine/telemetry.py over the
port's ``utils/hardware.py``, which holds the H100's peaks (so the
ratios are against one H100 SXM at 700 W) and the same roofline
formulas.

bench computes MFU and HBM-roofline utilization once, after the fact,
from hardcoded constants; nothing in-process knows how close the live
decode loop runs to the hardware ceiling. ``UtilizationEstimator``
closes that gap: the engine's dispatch thread records one cheap host
entry per compiled-program launch (kind, live rows, tokens produced,
how many passes over the streamed weights, cache read bytes), the
reader thread records per-kind readback stalls, and a rolling window
over those records feeds three registry families:

- ``genai_engine_mfu_ratio`` — forward tokens/sec x 2 FLOPs/matmul-param
  against the mesh's aggregate peak (same formula as bench, imported
  from ``utils/hardware.py`` so the two can never drift);
- ``genai_engine_hbm_bw_ratio`` — weight streaming + KV cache reads per
  second against the aggregate HBM roofline;
- ``genai_engine_step_time_seconds`` — per-decode-step wall time
  (dispatch-to-dispatch interval / fused steps), the live cadence
  signal.

Everything is host arithmetic at dispatch rate (~tens of records/sec at
serving batch sizes) — the estimator never touches the device and adds
no synchronization to the hot path.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from generativeaiexamples_tpu_torch.utils import hardware
from generativeaiexamples_tpu_torch.utils import metrics as metrics_mod

_REG = metrics_mod.get_registry()
_M_MFU = _REG.gauge(
    "genai_engine_mfu_ratio",
    "Rolling-window model-FLOPs utilization of the serving mesh "
    "(forward tokens/sec x 2 FLOPs per matmul parameter vs aggregate "
    "peak TFLOP/s; same formula as bench.py via utils/hardware.py).",
)
_M_HBM = _REG.gauge(
    "genai_engine_hbm_bw_ratio",
    "Rolling-window achieved HBM bandwidth (weight streaming + KV cache "
    "reads) as a fraction of the mesh's aggregate roofline.",
)
_M_STEP_TIME = _REG.histogram(
    "genai_engine_step_time_seconds",
    "Per-decode-step wall time seen by the dispatch thread "
    "(dispatch-to-dispatch interval divided by the fused step count).",
    # Bucket audit (PR 16): the 5 s top bucket saturated on CPU CI —
    # chunked-prefill admissions between decode dispatches stretch the
    # dispatch-to-dispatch interval past it, parking the whole p95 in
    # +Inf. Keep the sub-ms floor and extend the ceiling.
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0),
)


class UtilizationEstimator:
    """Rolling-window utilization gauges over per-dispatch step records.

    ``record_dispatch`` is called by the engine dispatch thread right
    after each compiled-program launch; ``record_readback`` by whichever
    thread pays the device-completion wait. Thread-safe via one small
    lock around the deque — contention is dispatch-rate, not token-rate.
    """

    def __init__(
        self,
        matmul_params: int,
        weight_stream_bytes: int,
        devices: int = 1,
        window_s: float = 10.0,
    ):
        self.matmul_params = int(matmul_params)
        self.weight_stream_bytes = int(weight_stream_bytes)
        self.devices = max(1, int(devices))
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        # (t, kind, tokens, hbm_bytes, rows) per dispatch, pruned to
        # window_s. Window token/byte/row totals are maintained
        # incrementally (append adds, prune subtracts) so the per-
        # dispatch gauge update is O(1) — this runs on the engine
        # dispatch thread, whose acceptance bar is "observability must
        # not regress the hot path".
        self._records: Deque[Tuple[float, str, int, int, int]] = deque(
            maxlen=4096
        )
        self._tok_total = 0
        self._hbm_total = 0
        self._row_total = 0
        self._readback: Dict[str, Tuple[float, int]] = {}  # kind -> (sum, n)
        # attention-path dispatch counts (cumulative, not windowed: the
        # bench/loadgen A/Bs difference run boundaries)
        self._path_counts: Dict[str, int] = {}
        # per-mode dispatch counts (cumulative, same contract): how many
        # launches each dispatch kind — prefill / decode / spec /
        # spec_block — contributed, so the bubble decomposition's
        # per-mode shares sit next to the launch mix that produced them
        self._kind_counts: Dict[str, int] = {}
        self._last_decode_t: Optional[float] = None

    # ------------------------------------------------------------------ #
    def record_dispatch(
        self,
        kind: str,
        tokens: int,
        weight_passes: int = 1,
        cache_bytes: int = 0,
        steps: int = 1,
        rows: int = 0,
        path: Optional[str] = None,
    ) -> None:
        """One compiled-program launch: ``tokens`` forward tokens
        produced/processed, ``weight_passes`` full streams over the
        non-embedding weights, ``cache_bytes`` of KV reads, ``steps``
        fused decode steps (for the step-time cadence), ``rows`` live
        batch rows (feeds snapshot()'s avg_rows_per_dispatch — the live
        batch-occupancy signal next to the ratios). ``path`` names the
        attention server for layout A/Bs (paged: 'kernel' = the ragged
        Pallas page kernel, whose ``cache_bytes`` are the per-row
        live-page ``kv_read_bytes_ragged`` sum, vs 'gather' = the XLA
        window gather charged at the padded window) — snapshot() emits
        cumulative per-path dispatch counts next to the ratios."""
        now = time.monotonic()
        hbm_bytes = self.weight_stream_bytes * max(0, weight_passes) + max(
            0, cache_bytes
        )
        with self._lock:
            if len(self._records) == self._records.maxlen:
                # deque would drop the oldest silently; keep totals exact
                self._drop_oldest_locked()
            self._records.append(
                (now, kind, int(tokens), int(hbm_bytes), int(rows))
            )
            if path:
                self._path_counts[path] = self._path_counts.get(path, 0) + 1
            self._kind_counts[kind] = self._kind_counts.get(kind, 0) + 1
            self._tok_total += int(tokens)
            self._hbm_total += int(hbm_bytes)
            self._row_total += int(rows)
            if kind in ("decode", "spec", "spec_block"):
                if self._last_decode_t is not None:
                    dt = now - self._last_decode_t
                    if 0 < dt < self.window_s:
                        _M_STEP_TIME.observe(dt / max(1, steps), trace_id=None)
                self._last_decode_t = now
            self._update_gauges_locked(now)

    def record_readback(self, kind: str, stall_s: float) -> None:
        with self._lock:
            s, n = self._readback.get(kind, (0.0, 0))
            self._readback[kind] = (s + float(stall_s), n + 1)

    # ------------------------------------------------------------------ #
    def _drop_oldest_locked(self) -> None:
        _, _, tokens, hbm, rows = self._records.popleft()
        self._tok_total -= tokens
        self._hbm_total -= hbm
        self._row_total -= rows

    def _prune_locked(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._records and self._records[0][0] < cutoff:
            self._drop_oldest_locked()

    def _update_gauges_locked(self, now: float) -> None:
        self._prune_locked(now)
        if not self._records:
            _M_MFU.set(0.0)
            _M_HBM.set(0.0)
            return
        span = max(now - self._records[0][0], 1e-3)
        _M_MFU.set(
            hardware.mfu_ratio(
                self._tok_total / span, self.matmul_params, self.devices
            )
        )
        _M_HBM.set(hardware.hbm_ratio(self._hbm_total / span, self.devices))

    # ------------------------------------------------------------------ #
    def snapshot(self) -> Dict[str, float]:
        """Current rolling-window view (the bench JSON line and
        ``/internal/slo`` read this): gauge values plus the raw
        tokens/sec and per-kind readback averages."""
        now = time.monotonic()
        with self._lock:
            self._update_gauges_locked(now)
            out: Dict[str, float] = {
                "mfu_ratio": round(_M_MFU.value, 5),
                "hbm_bw_ratio": round(_M_HBM.value, 5),
                "window_s": self.window_s,
            }
            if self._records:
                span = max(now - self._records[0][0], 1e-3)
                out["tokens_per_sec"] = round(self._tok_total / span, 1)
                out["dispatches_in_window"] = len(self._records)
                out["avg_rows_per_dispatch"] = round(
                    self._row_total / len(self._records), 2
                )
            for kind, (s, n) in sorted(self._readback.items()):
                out[f"readback_{kind}_avg_s"] = round(s / max(1, n), 5)
            for path, n in sorted(self._path_counts.items()):
                out[f"dispatches_path_{path}"] = n
            for kind, n in sorted(self._kind_counts.items()):
                out[f"dispatches_kind_{kind}"] = n
        return out
