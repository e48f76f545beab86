"""Reading the device track of a ``torch.profiler`` capture.

Counterpart of generativeaiexamples_tpu/utils/xplane.py, which reads a
``jax.profiler`` capture's TPU track. Here the capture is a
``torch.profiler`` session with CUDA activity (utils/profiling.py writes
its Chrome trace; a live session's events are read straight from the
profiler) and the device track is every CUDA kernel, copy and memset it
holds:

- busy time is the union of the device intervals (overlapping streams
  count once), idle share ``1 - busy / wall``;
- attribution by kernel name: the port's kernels by the names of their
  ``__global__`` functions (:data:`PORT_KERNEL_NAMES`), PyTorch's under
  ``torch``;
- attribution by category (:func:`categorize`): JAX's decode-step
  categories, with the CUDA kernel names mapped into them (the port's
  kernels are ``pallas-kernel``, their counterpart; kernels launched
  inside the TP reduce's ``tp.reduce`` label are ``collective``);
- completeness: CUPTI on the card can drop every event of a session, or
  some of them, so each port kernel's events in a trace are compared with
  the times its wrapper launched that kernel over the same window
  (:func:`kernel_counts`: one wrapper call can launch two kernels, the
  paged split and merge, the W8A8 quantizer and product), counted from
  :data:`START_GUARD_S` into the session. A trace holding
  fewer of any one kernel is ``complete: false`` and its busy time and
  idle share are None: never a figure from a partial trace. Nor is there
  one where the union of the device intervals outlasts the window's wall
  clock (``not_measured`` says which).

:class:`DeviceWindow` wraps one traced window for scripts (chip_smoke.py);
the serving process captures through ``POST /internal/profile/start`` and
``/stop``, which must not overlap another profiler session.
"""
from __future__ import annotations

import bisect
import json
import re
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "PORT_KERNEL_NAMES",
    "CATEGORIES",
    "REDUCE_LABEL",
    "categorize",
    "launch_counts",
    "kernel_counts",
    "reset_launch_counts",
    "busy_ms",
    "profile_events",
    "chrome_trace_events",
    "analyze",
    "device_track_events",
    "DeviceWindow",
]

# the port's kernels by the names of their __global__ functions (every
# W8A8 kernel name starts "w8a8_")
PORT_KERNEL_NAMES = re.compile(
    r"int8_matmul_mma|w8a8_|paged_(split|merge)_kernel|flash_attention_kernel|decode_split_kernel")

# each port kernel by the name of its __global__ function, as
# kernel_counts() counts its launches
_KERNEL = re.compile(
    r"int8_matmul_mma|w8a8_mma|w8a8_quantize|paged_split_kernel|paged_merge_kernel"
    r"|flash_attention_kernel|decode_split_kernel")

# Chrome-trace categories of device work in a torch.profiler export
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: how far into a CUDA profiler session its window starts counting launches:
#: CUPTI records no kernel for launches in a session's first milliseconds
#: (on an H100, launches up to 3.2 ms in had runtime records and no kernel
#: records), so a window counted from the session's start read incomplete
START_GUARD_S = 0.05

Event = Tuple[str, float, float]  # (name, start us, end us)

# JAX's decode-step categories (generativeaiexamples_tpu/utils/xplane.py)
CATEGORIES = ("pallas-kernel", "cache-scatter", "copy/layout", "sampling", "collective",
              "fusion/matmul", "other")

# the record_function label of the TP row reduce (parallel/tp_kernels.py):
# a kernel launched inside it is named "tp.reduce/<kernel>" by
# profile_events, and counts as a collective
REDUCE_LABEL = "tp.reduce"

_CUDA_RULES = (
    ("cache-scatter", re.compile(r"index_put|index_copy|indexing_backward")),
    ("copy/layout", re.compile(
        r"memcpy|memset|copy_kernel|catarraybatchedcopy|index_?select|gather_kernel")),
    ("sampling", re.compile(
        r"topk|top_k|radixsort|bitonic|argmax|argmin|scan|cumsum|bitwise|shift|"
        r"philox|curand|multinomial")),
    ("collective", re.compile(r"nccl|ptop")),
    ("fusion/matmul", re.compile(
        r"gemm|nvjet|cutlass|xmma|cublas|sm90_|sm80_|at::native|flash|softmax|norm")),
)


def _jax_category(n: str) -> str:
    """JAX's ``categorize`` on a lower-cased name, rule for rule."""
    if "custom-call" in n or "tpu_custom_call" in n or "pallas" in n:
        return "pallas-kernel"
    if "dynamic-update-slice" in n or "scatter" in n:
        return "cache-scatter"
    if n.startswith("copy") or "transpose" in n or "bitcast" in n:
        return "copy/layout"
    if "sort" in n or "top-k" in n or "rng" in n or "iota" in n:
        return "sampling"
    if "all-reduce" in n or "all-gather" in n or "collective" in n:
        return "collective"
    if "fusion" in n or "dot" in n or "convolution" in n:
        return "fusion/matmul"
    return "other"


def categorize(name: str) -> str:
    """Bucket one device event into JAX's categories (:data:`CATEGORIES`).
    The port's kernels are ``pallas-kernel`` (their counterpart) and a
    kernel of the TP reduce (``tp.reduce/`` prefix) is ``collective``;
    every other name goes through JAX's rules first, so a name both
    packages can see lands where JAX puts it, and what JAX calls
    ``other`` through the CUDA names: ``index_put_``/``index_copy_``
    kernels are cache scatters, copies, memsets, ``cat`` and gathers
    layout, sorts, top-k, argmax, scans and the threefry draw's bit
    operations sampling, NCCL and peer copies collective, and cuBLAS/nvjet
    GEMMs and PyTorch's own kernels (elementwise, reductions) fusion/matmul."""
    if name.startswith(REDUCE_LABEL + "/"):
        return "collective"
    if PORT_KERNEL_NAMES.search(name):
        return "pallas-kernel"
    n = name.lower()
    cat = _jax_category(n)
    if cat != "other":
        return cat
    for cat, pattern in _CUDA_RULES:
        if pattern.search(n):
            return cat
    return "other"


def _counted():
    from generativeaiexamples_tpu_torch.ops import decode_attention as da
    from generativeaiexamples_tpu_torch.ops import flash_attention as fa
    from generativeaiexamples_tpu_torch.ops import int8_matmul as im
    from generativeaiexamples_tpu_torch.ops import page_attention as pa

    return (im.int8_matmul, im.int8_w8a8_matmul, fa.flash_attention_causal,
            da.decode_attention), pa.paged_attention


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's launch count (a wrapper counts where it
    launches its kernel, never on the CPU path), paged attention by KV
    dtype."""
    fns, paged = _counted()
    out = {fn.__name__: fn.launches for fn in fns}
    for kv, n in paged.launches.items():
        out[f"paged_attention[{kv}]"] = n
    return out


def kernel_counts() -> Dict[str, int]:
    """The times each port kernel was launched, by the name of its
    ``__global__`` function: every wrapper call launches its first kernel,
    a paged call of more than one split the merge kernel too, a W8A8 call
    at ``K >= W8A8_TWO_LAUNCH_K`` the quantizer too."""
    (mm, w8a8, flash, decode), paged = _counted()
    return {
        "int8_matmul_mma": mm.launches,
        "w8a8_mma": w8a8.launches,
        "w8a8_quantize": w8a8.quantize_launches,
        "paged_split_kernel": sum(paged.launches.values()),
        "paged_merge_kernel": paged.merge_launches,
        "flash_attention_kernel": flash.launches,
        "decode_split_kernel": decode.launches,
    }


def reset_launch_counts() -> None:
    fns, paged = _counted()
    for fn in fns:
        fn.launches = 0
    for kv in paged.launches:
        paged.launches[kv] = 0
    fns[1].quantize_launches = 0
    paged.merge_launches = 0


def busy_ms(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of the intervals ``spans`` (us), in ms."""
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(spans):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def _labelled_ops(cpu_events, label: str) -> set:
    """Correlation ids of the CPU ops that ran inside a ``label`` range on
    their own thread; ``cpu_events`` are (name, thread, start ns, end ns,
    correlation id)."""
    spans: Dict[int, List[Tuple[int, int]]] = {}
    for name, thread, start, end, _ in cpu_events:
        if name == label:
            spans.setdefault(thread, []).append((start, end))
    if not spans:
        return set()
    for v in spans.values():
        v.sort()
    starts = {t: [a for a, _ in v] for t, v in spans.items()}
    out = set()
    for name, thread, start, _, corr in cpu_events:
        if name == label or thread not in spans:
            continue
        i = bisect.bisect_right(starts[thread], start) - 1
        if i >= 0 and start <= spans[thread][i][1]:
            out.add(corr)
    return out


def _is_annotation(e) -> bool:
    """Whether a Kineto event is a ``record_function`` label (on the CPU,
    or its ``gpu_user_annotation`` span on the device), not work."""
    flag = getattr(e, "is_user_annotation", None)
    if flag is not None and flag():
        return True
    kind = getattr(e, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


def profile_events(prof) -> List[Event]:
    """Device events of a stopped ``torch.profiler.profile``, from its raw
    Kineto results (building the FunctionEvent tree takes minutes for a
    few hundred thousand events): kernels, copies and memsets. The
    device spans Kineto draws for ``record_function`` labels (the
    engine's dispatch labels under ``ENABLE_PROFILING``) are no device
    work and are left out. A kernel whose launching CPU op ran inside a
    :data:`REDUCE_LABEL` range (a capture with CPU activity) is named
    ``tp.reduce/<kernel>``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    raw = list(prof.profiler.kineto_results.events())
    cpu = [e for e in raw if e.device_type() != cuda]
    labels = {e.name() for e in cpu if _is_annotation(e)} | {REDUCE_LABEL}
    reduce_ops = _labelled_ops(
        [(e.name(), e.start_thread_id(), e.start_ns(), e.start_ns() + e.duration_ns(),
          e.correlation_id()) for e in cpu], REDUCE_LABEL)
    out = []
    for e in raw:
        if e.device_type() != cuda or e.name() in labels or _is_annotation(e):
            continue
        name = e.name()
        if reduce_ops and e.linked_correlation_id() in reduce_ops:
            name = f"{REDUCE_LABEL}/{name}"
        out.append((name, e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3))
    return out



def chrome_trace_events(path: str) -> List[Event]:
    """Device events of a Chrome trace that ``export_chrome_trace``
    wrote (raises FileNotFoundError when there is none)."""
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    out = []
    for e in data.get("traceEvents", ()):
        if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS:
            ts = float(e.get("ts", 0.0))
            out.append((str(e.get("name", "")), ts, ts + float(e.get("dur", 0.0))))
    return out


def _family(name: str) -> str:
    m = PORT_KERNEL_NAMES.search(name)
    return m.group(0) if m else "torch"


def analyze(events: Sequence[Event], launched: Mapping[str, int],
            wall_ms: Optional[float] = None) -> Dict[str, Any]:
    """Busy time, idle share, per-kernel device time (``kernels_ms``) and
    device time by JAX's category (``categories_ms``) of a window's device
    ``events``, against the port kernels the wrappers launched over it
    (``launched``: :func:`kernel_counts` over the window). ``complete``
    is False where the trace holds fewer events of any one kernel than its
    launches; busy time, idle share and the attribution are then None, as
    they are for a trace with no device event at all (a CPU run) and for
    one whose busy time exceeds ``wall_ms`` (``not_measured`` names the
    case)."""
    seen: Dict[str, int] = {}
    port = 0
    for name, _, _ in events:
        if PORT_KERNEL_NAMES.search(name):
            port += 1
            m = _KERNEL.search(name)
            if m:
                seen[m.group(0)] = seen.get(m.group(0), 0) + 1
    launched = {k: int(n) for k, n in launched.items() if n}
    out: Dict[str, Any] = {
        "complete": all(seen.get(k, 0) >= n for k, n in launched.items()),
        "port_kernels_in_trace": port,
        "port_launches": sum(launched.values()),
        "kernels_in_trace": dict(sorted(seen.items())),
        "kernels_launched": dict(sorted(launched.items())),
        "device_events": len(events),
        "wall_ms": wall_ms,
        "busy_ms": None,
        "idle_share": None,
        "kernels_ms": None,
        "categories_ms": None,
        "not_measured": None,
    }
    if not out["complete"]:
        out["not_measured"] = "incomplete"
        return out
    if not events:
        out["not_measured"] = "no device events"
        return out
    busy = busy_ms((a, b) for _, a, b in events)
    if wall_ms is not None and busy > wall_ms:
        out["not_measured"] = "busy exceeds wall"
        return out
    by: Dict[str, float] = {}
    cats = dict.fromkeys(CATEGORIES, 0.0)
    for name, a, b in events:
        fam = _family(name)
        by[fam] = by.get(fam, 0.0) + (b - a) / 1e3
        cats[categorize(name)] += (b - a) / 1e3
    out["busy_ms"] = busy
    out["kernels_ms"] = dict(sorted(by.items()))
    out["categories_ms"] = cats
    if wall_ms:
        out["idle_share"] = 1.0 - busy / wall_ms
    return out


def device_track_events(path: str) -> List[Dict[str, Any]]:
    """A Chrome trace's kernel spans as the dispatch timeline's Perfetto
    device track takes them (``{"name", "ts_us", "dur_us", "tid"}``,
    chronological; the tid is the stream). Raises FileNotFoundError when
    the file is missing."""
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    out = [
        {"name": str(e.get("name", "")), "ts_us": float(e.get("ts", 0.0)),
         "dur_us": float(e.get("dur", 0.0)), "tid": int(e.get("tid", 1) or 1)}
        for e in data.get("traceEvents", ())
        if e.get("ph") == "X" and e.get("cat") == "kernel"
    ]
    out.sort(key=lambda d: d["ts_us"])
    return out


class DeviceWindow:
    """One ``torch.profiler`` CUDA session over a timed window (``trace``;
    else the wall clock alone). The trace runs from ``__enter__`` to a
    device synchronize at ``__exit__``: ``wall_ms`` is the host clock over
    it and ``result`` the :func:`analyze` of its device events against the
    wrappers' launches meanwhile, counted from START_GUARD_S into the
    session (a kernel launched before the window opened is not in it). ``busy_ms`` and ``events`` mirror the result:
    None where the trace is incomplete."""

    def __init__(self, trace: bool = True):
        self.trace = trace
        self.wall_ms = self.busy_ms = self.events = None
        self.result: Optional[Dict[str, Any]] = None

    def __enter__(self):
        self._prof = None
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            time.sleep(START_GUARD_S)
        self._launched = kernel_counts()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        launched = {k: n - self._launched[k] for k, n in kernel_counts().items()}
        torch.cuda.synchronize()  # every launch of the window is in the trace
        self.wall_ms = (time.perf_counter() - self._t0) * 1e3
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        self.result = analyze(profile_events(self._prof), launched, self.wall_ms)
        if self.result["busy_ms"] is not None:
            self.busy_ms, self.events = self.result["busy_ms"], self.result["device_events"]
        return False
