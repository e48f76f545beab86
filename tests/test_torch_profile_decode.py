"""The decode profiler (generativeaiexamples_tpu_torch/tools/profile_decode.py)
and the category attribution it reads (utils/device_trace.py
``categorize``), on the CPU.

- ``categorize`` agrees with JAX's (generativeaiexamples_tpu/utils/xplane.py)
  on every XLA op name both can see, and buckets the CUDA kernel names
  into JAX's categories: the port's kernels ``pallas-kernel``,
  ``index_put_``/``index_copy_`` ``cache-scatter``, copies and ``cat``
  ``copy/layout``, sorts, top-k, argmax and the threefry bit operations
  ``sampling``, the TP reduce's kernels (launched inside its
  ``tp.reduce`` label) ``collective``, GEMMs and PyTorch's elementwise
  kernels ``fusion/matmul`` (exact: names to labels).
- ``analyze`` sums device time by category beside ``kernels_ms`` and gives
  no figure from an incomplete trace.
- ``profile_decode`` with ``--device cpu`` on a tiny config: a report of
  decode steps whose device figures are ``not_measured: "no device
  events"``; with no card and no ``--device`` it raises.
"""
import json

import pytest

from generativeaiexamples_tpu.utils import xplane
from generativeaiexamples_tpu_torch.tools import profile_decode
from generativeaiexamples_tpu_torch.utils import device_trace, profiling

XLA_NAMES = ["all-reduce.3", "all-gather.1", "collective-permute.2", "copy.1", "copy-start.4",
             "transpose.7", "bitcast.2", "sort.1", "top-k", "rng-bit-generator", "iota.5",
             "fusion.12", "dot.4", "convolution.1", "custom-call.5", "tpu_custom_call",
             "pallas_call", "dynamic-update-slice.3", "scatter.2", "while.1", "parameter.0",
             "reduce.9", "broadcast.2"]

CUDA_NAMES = {
    "void (anonymous namespace)::int8_matmul_mma<1>(__nv_bfloat16 const*)": "pallas-kernel",
    "void (anonymous namespace)::paged_split_kernel<0, 128>(Args)": "pallas-kernel",
    "void (anonymous namespace)::w8a8_quantize(float const*)": "pallas-kernel",
    "tp.reduce/void at::native::vectorized_elementwise_kernel<4, "
    "at::native::CUDAFunctor_add<float>>": "collective",
    "tp.reduce/Memcpy PtoP (Device -> Device)": "collective",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)": "collective",
    "void at::native::index_put_kernel_impl<at::native::OpaqueType<2>>(x)": "cache-scatter",
    "void at::native::index_copy_kernel_impl<at::native::OpaqueType<2>>(x)": "cache-scatter",
    "void at::native::_scatter_gather_elementwise_kernel<128, 8>(x)": "cache-scatter",
    "Memcpy DtoD (Device -> Device)": "copy/layout",
    "Memset (Device)": "copy/layout",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<x>(x)": "copy/layout",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda>(x)":
        "copy/layout",
    "void at::native::bitonicSortKVInPlace<2, -1, 16, 16>(x)": "sampling",
    "void at::native::sbtopk::gatherTopK<float, unsigned int, 2, false>(x)": "sampling",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::ArgMaxOps<float>>>(x)": "sampling",
    "void at::native::vectorized_elementwise_kernel<4, at::native::BitwiseXorFunctor<long>>(x)":
        "sampling",
    "nvjet_tst_320x128_64x3_2x4_h_bz_coopB_NNT": "fusion/matmul",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": "fusion/matmul",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>(x)":
        "fusion/matmul",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::MeanOps<float, float>>>(x)": "fusion/matmul",
}


@pytest.mark.parametrize("name", XLA_NAMES)
def test_categorize_agrees_with_jax_on_xla_names(name):
    assert device_trace.categorize(name) == xplane.categorize(name)


@pytest.mark.parametrize("name,want", list(CUDA_NAMES.items()))
def test_categorize_buckets_cuda_names(name, want):
    assert device_trace.categorize(name) == want
    assert want in device_trace.CATEGORIES


def test_kernels_in_the_reduce_label_are_attributed_to_it():
    """(name, thread, start ns, end ns, correlation id) CPU events: the
    ops inside a ``tp.reduce`` range on their own thread, and only they."""
    cpu = [("tp.reduce", 1, 100, 200, 1), ("aten::add", 1, 120, 130, 2),
           ("aten::to", 1, 150, 160, 3), ("aten::add", 2, 120, 130, 4),
           ("aten::mm", 1, 250, 260, 5), ("tp.reduce", 1, 300, 400, 6),
           ("aten::add", 1, 310, 320, 7)]
    assert device_trace._labelled_ops(cpu, device_trace.REDUCE_LABEL) == {2, 3, 7}
    assert device_trace._labelled_ops(cpu[1:5], device_trace.REDUCE_LABEL) == set()


def test_analyze_sums_device_time_by_category():
    mm = "void (anonymous namespace)::int8_matmul_mma<1>(x)"
    events = [(mm, 0.0, 100.0), ("tp.reduce/void at::native::add_kernel(x)", 100.0, 110.0),
              ("void at::native::index_put_kernel_impl<x>(x)", 120.0, 125.0),
              ("nvjet_tst_64x8", 130.0, 150.0)]
    out = device_trace.analyze(events, {"int8_matmul_mma": 1}, wall_ms=1.0)
    assert out["complete"] and out["busy_ms"] == pytest.approx(0.135)
    assert out["categories_ms"] == pytest.approx({
        "pallas-kernel": 0.1, "cache-scatter": 0.005, "copy/layout": 0.0, "sampling": 0.0,
        "collective": 0.01, "fusion/matmul": 0.02, "other": 0.0})
    assert sum(out["categories_ms"].values()) == pytest.approx(sum(out["kernels_ms"].values()))
    lost = device_trace.analyze(events, {"int8_matmul_mma": 2}, wall_ms=1.0)
    assert not lost["complete"] and lost["categories_ms"] is None and lost["busy_ms"] is None


def test_profile_decode_on_the_cpu_reports_no_device_figures(monkeypatch, tmp_path, capsys):
    for key, value in {"BENCH_MODEL": "debug-1k", "BENCH_BATCH": "2", "BENCH_SEQ": "1024",
                       "BENCH_PROMPT": "16", "PROFILE_SECONDS": "0.3", "BENCH_TP": "2",
                       "PROFILE_DIR": str(tmp_path)}.items():
        monkeypatch.setenv(key, value)
    cfg = profile_decode.engine_config()
    assert (cfg.model_config_name, cfg.max_batch_size, cfg.tensor_parallelism,
            cfg.prefill_chunk, cfg.quantization) == ("debug-1k", 2, 2, 128, "int8")
    assert profile_decode.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    report = json.loads(out[-1])
    assert report["window"] == "decode" and report["shards"] == 2 and report["slots"] == 2
    assert report["decode_steps"] > 0 and report["complete"] is True
    assert report["not_measured"] == "no device events"
    assert report["busy_ms"] is None and report["categories_ms"] is None
    assert report["trace"].startswith(str(tmp_path))
    assert any("device figures not measured: no device events" in line for line in out)
    assert not profiling.capture_active()


def test_profile_decode_raises_with_no_card_and_no_device(monkeypatch):
    monkeypatch.setenv("BENCH_MODEL", "debug")
    with pytest.raises(RuntimeError, match="none is visible; pass --device cpu"):
        profile_decode.main([])
    monkeypatch.setenv("BENCH_PAGED_KERNEL", "interpret")
    with pytest.raises(ValueError, match="BENCH_PAGED_KERNEL=interpret"):
        profile_decode.engine_config()


def test_a_trace_window_holds_the_one_capture_slot(tmp_path, monkeypatch):
    monkeypatch.setenv("ENABLE_PROFILING", "true")
    with profiling.TraceWindow() as win:
        assert profiling.capture_active()
        assert profiling.start_profile(str(tmp_path))[0] == 409
        with pytest.raises(RuntimeError, match="already running"):
            profiling.TraceWindow().__enter__()
    assert not profiling.capture_active()
    assert win.result["trace"] is None and win.events == []


class _Kineto:
    """A Kineto event as ``profile_events`` reads it."""

    def __init__(self, name, cuda, start, dur, thread=1, corr=0, linked=0, annotation=False):
        import torch

        self._v = dict(name=name, start=start, dur=dur, thread=thread, corr=corr, linked=linked,
                       annotation=annotation,
                       device=torch.autograd.DeviceType.CUDA if cuda else
                       torch.autograd.DeviceType.CPU)

    def name(self):
        return self._v["name"]

    def device_type(self):
        return self._v["device"]

    def start_ns(self):
        return self._v["start"]

    def duration_ns(self):
        return self._v["dur"]

    def start_thread_id(self):
        return self._v["thread"]

    def correlation_id(self):
        return self._v["corr"]

    def linked_correlation_id(self):
        return self._v["linked"]

    def is_user_annotation(self):
        return self._v["annotation"]

    def activity_type(self):
        return "user_annotation" if self._v["annotation"] else "kernel"


def test_profile_events_drop_label_spans_and_name_the_reduce_s_kernels():
    """A ``record_function`` label's device span is no device work; a
    kernel launched by an op inside ``tp.reduce`` carries the label."""
    import types

    add = "void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>"
    raw = [_Kineto("engine.decode_block", False, 0, 10_000, annotation=True),
           _Kineto("tp.reduce", False, 1_000, 2_000, annotation=True),
           _Kineto("aten::add", False, 1_500, 100, corr=7),
           _Kineto("aten::mm", False, 5_000, 100, corr=8),
           _Kineto("engine.decode_block", True, 2_000, 20_000),
           _Kineto("tp.reduce", True, 2_100, 300),
           _Kineto(add, True, 2_100, 300, linked=7),
           _Kineto("nvjet_tst_64x8", True, 6_000, 1_000, linked=8)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: raw)))
    assert device_trace.profile_events(prof) == [(f"tp.reduce/{add}", 2.1, 2.4),
                                                 ("nvjet_tst_64x8", 6.0, 7.0)]
