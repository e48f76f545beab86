"""The port's profiler capture (generativeaiexamples_tpu_torch/utils/profiling.py)
and device-trace reader (utils/device_trace.py).

``start_profile``/``stop_profile`` answer JAX's status codes (403 while
``ENABLE_PROFILING`` is off, 409 on a second start or a stop with nothing
running) with JAX's JSON keys plus the device-track reading; a CPU
``torch.profiler`` capture works end to end (a Chrome trace is written
under the log dir, and with no device events its busy time and idle share
are None); a synthetic device trace holding fewer port kernels than the
wrappers counted reads ``complete: false`` with both counts and no busy
time, and a complete one gives the union of its intervals; the Chrome
trace's kernel spans read back as the timeline's device track.
``annotation_scope`` is ``record_function`` only with profiling on. Exact
comparisons: no tolerance applies (times are made-up microseconds)."""
import contextlib
import json
import threading

import pytest
import torch

from generativeaiexamples_tpu.utils import profiling as jprof
from generativeaiexamples_tpu_torch.utils import device_trace
from generativeaiexamples_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _idle():
    yield
    if profiling.capture_active():  # never leak a session into another test
        profiling._ACTIVE.stop()
        profiling._ACTIVE = None


def test_disabled_answers_403_as_jax(monkeypatch):
    monkeypatch.delenv("ENABLE_PROFILING", raising=False)
    assert profiling.start_profile() == jprof.start_profile()
    assert profiling.stop_profile() == jprof.stop_profile()
    assert profiling.start_profile()[0] == 403


def test_cpu_capture_through_start_and_stop(tmp_path, monkeypatch):
    monkeypatch.setenv("ENABLE_PROFILING", "true")
    status, body = profiling.start_profile(str(tmp_path))
    assert (status, body) == (200, {"ok": True, "log_dir": str(tmp_path)})
    status, again = profiling.start_profile(str(tmp_path))
    assert status == 409 and set(again) == {"error", "log_dir"}
    with torch.profiler.record_function("engine.decode_block"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    # stopped from another thread, as the next HTTP request's would
    result = {}
    stopper = threading.Thread(target=lambda: result.update(r=profiling.stop_profile()),
                               name="test-profile-stop")
    stopper.start()
    stopper.join(120)
    status, body = result["r"]
    assert status == 200
    assert {"ok", "log_dir", "duration_s"} <= set(body)  # JAX's keys
    assert body["complete"] is True and body["port_launches"] == 0
    assert body["device_events"] == 0 and body["busy_ms"] is None and body["idle_share"] is None
    with open(body["trace"]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "engine.decode_block" in names
    assert profiling.stop_profile()[0] == 409


def _synthetic(tmp_path, n_port):
    events = [{"ph": "X", "cat": "kernel", "name": "int8_matmul_mma_kernel<1>", "ts": 10.0 * i,
               "dur": 4.0, "pid": 0, "tid": 7} for i in range(n_port)]
    events += [{"ph": "X", "cat": "kernel", "name": "at::native::elementwise_kernel", "ts": 2.0,
                "dur": 5.0, "pid": 0, "tid": 7},
               {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 100.0, "dur": 1.0,
                "pid": 0, "tid": 8},
               {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 500.0}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_a_trace_with_fewer_port_kernels_than_launches_is_incomplete(tmp_path):
    events = device_trace.chrome_trace_events(_synthetic(tmp_path, 3))
    out = device_trace.analyze(events, launched={"int8_matmul_mma": 5}, wall_ms=1.0)
    assert out["complete"] is False and out["not_measured"] == "incomplete"
    assert (out["port_kernels_in_trace"], out["port_launches"]) == (3, 5)
    assert out["busy_ms"] is None and out["idle_share"] is None and out["kernels_ms"] is None


def test_a_trace_that_lost_the_merge_kernels_is_incomplete(tmp_path):
    """Two paged calls of more than one split launched 2 split and 2 merge
    kernels: a trace that holds 4 split kernels (launched before the
    window, run in it) and no merge is still incomplete."""
    split = [("void paged_split_kernel<0, 128>(Args)", 10.0 * i, 10.0 * i + 4) for i in range(4)]
    launched = {"paged_split_kernel": 2, "paged_merge_kernel": 2, "int8_matmul_mma": 0}
    out = device_trace.analyze(split, launched=launched, wall_ms=1.0)
    assert out["complete"] is False and out["busy_ms"] is None
    assert out["kernels_in_trace"] == {"paged_split_kernel": 4}
    assert out["kernels_launched"] == {"paged_merge_kernel": 2, "paged_split_kernel": 2}
    merge = [("void paged_merge_kernel<128>(Args)", 10.0 * i + 5, 10.0 * i + 6) for i in range(2)]
    assert device_trace.analyze(split + merge, launched=launched, wall_ms=1.0)["complete"] is True


def test_a_trace_busier_than_its_wall_is_not_measured(tmp_path):
    events = device_trace.chrome_trace_events(_synthetic(tmp_path, 3))
    out = device_trace.analyze(events, launched={"int8_matmul_mma": 3}, wall_ms=0.01)
    assert out["complete"] is True and out["not_measured"] == "busy exceeds wall"
    assert out["busy_ms"] is None and out["idle_share"] is None and out["kernels_ms"] is None


def test_a_complete_trace_gives_the_union_of_its_intervals(tmp_path):
    events = device_trace.chrome_trace_events(_synthetic(tmp_path, 3))
    out = device_trace.analyze(events, launched={"int8_matmul_mma": 3}, wall_ms=0.1)
    # [0,4] u [2,7] u [10,14] u [20,24] u [100,101] = 7 + 4 + 4 + 1 us
    assert out["complete"] is True and out["device_events"] == 5
    assert out["not_measured"] is None
    assert out["busy_ms"] == pytest.approx(0.016, abs=1e-12)
    assert out["idle_share"] == pytest.approx(1.0 - 0.016 / 0.1, abs=1e-12)
    assert out["kernels_ms"] == pytest.approx({"int8_matmul_mma": 0.012, "torch": 0.006},
                                              abs=1e-12)


def test_kernel_spans_read_back_as_the_device_track(tmp_path):
    track = device_trace.device_track_events(_synthetic(tmp_path, 2))
    assert [(e["name"], e["ts_us"], e["tid"]) for e in track] == [
        ("int8_matmul_mma_kernel<1>", 0.0, 7), ("at::native::elementwise_kernel", 2.0, 7),
        ("int8_matmul_mma_kernel<1>", 10.0, 7)]
    with pytest.raises(FileNotFoundError):
        device_trace.device_track_events(str(tmp_path / "missing.json"))


@pytest.mark.parametrize("name,port", [
    ("int8_matmul_mma_kernel", True), ("w8a8_gemm_kernel", True), ("paged_split_kernel", True),
    ("paged_merge_kernel", True), ("flash_attention_kernel", True),
    ("decode_split_kernel", True), ("at::native::vectorized_elementwise_kernel", False),
    ("ampere_bf16_s16816gemm", False),
])
def test_port_kernel_names(name, port):
    assert bool(device_trace.PORT_KERNEL_NAMES.search(name)) is port


def test_kernel_counts_name_every_port_kernel():
    counts = device_trace.kernel_counts()
    assert set(counts) == {"int8_matmul_mma", "w8a8_mma", "w8a8_quantize", "paged_split_kernel",
                           "paged_merge_kernel", "flash_attention_kernel", "decode_split_kernel"}
    assert all(device_trace.PORT_KERNEL_NAMES.search(name) for name in counts)


def test_launch_counts_cover_every_wrapper():
    counts = device_trace.launch_counts()
    assert {"int8_matmul", "int8_w8a8_matmul", "flash_attention_causal", "decode_attention",
            "paged_attention[bfloat16]", "paged_attention[int8]",
            "paged_attention[int4]"} <= set(counts)


def test_annotation_scope_follows_enable_profiling(monkeypatch):
    monkeypatch.delenv("ENABLE_PROFILING", raising=False)
    assert isinstance(profiling.annotation_scope()("x"), contextlib.nullcontext)
    monkeypatch.setenv("ENABLE_PROFILING", "1")
    assert profiling.annotation_scope() is torch.profiler.record_function
