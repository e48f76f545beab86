"""The port's utilization estimator (generativeaiexamples_tpu_torch/engine/telemetry.py)
against the JAX package's (generativeaiexamples_tpu/engine/telemetry.py).

The same dispatch and readback records (drawn from a numpy seed) at the
same clock readings give the same snapshot: tokens/sec, dispatch counts by
path and kind, rows, readback averages and the step-time samples are
equal, and the MFU and HBM ratios are equal once each package's peak is
divided out (the port's peaks are one H100's, utils/hardware.py; JAX's a
TPU chip's): ``ratio * peak`` agrees within 1e-9 relative (the ratios are
rounded to 5 digits in the snapshot, so the raw gauges are compared)."""
import math

import numpy as np
import pytest

from generativeaiexamples_tpu.engine import telemetry as jtel
from generativeaiexamples_tpu.utils import hardware as jhw
from generativeaiexamples_tpu_torch.engine import telemetry as ttel
from generativeaiexamples_tpu_torch.utils import hardware as thw

KINDS = ("prefill", "decode", "spec", "spec_block")


def _drive(mod, seed, monkeypatch):
    now = {"t": 10.0}
    monkeypatch.setattr(mod.time, "monotonic", lambda: now["t"])
    est = mod.UtilizationEstimator(matmul_params=7_000_000_000, weight_stream_bytes=8 * 2**30,
                                   window_s=5.0)
    steps = mod._M_STEP_TIME.count
    rng = np.random.default_rng(seed)
    gauges = []
    for _ in range(120):
        now["t"] += float(rng.uniform(0.001, 0.2))
        if rng.integers(0, 4):
            est.record_dispatch(
                KINDS[int(rng.integers(0, 4))], tokens=int(rng.integers(1, 64)),
                weight_passes=int(rng.integers(0, 9)), cache_bytes=int(rng.integers(0, 2**28)),
                steps=int(rng.integers(1, 9)), rows=int(rng.integers(0, 9)),
                path=("kernel", "gather", None)[int(rng.integers(0, 3))],
            )
            gauges.append((mod._M_MFU.value, mod._M_HBM.value))
        else:
            est.record_readback(KINDS[int(rng.integers(0, 4))], float(rng.exponential(0.01)))
    snap = est.snapshot()
    return snap, gauges, mod._M_STEP_TIME.count - steps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshots_are_jax_s_up_to_the_peaks(seed, monkeypatch):
    js, jg, jn = _drive(jtel, seed, monkeypatch)
    ts, tg, tn = _drive(ttel, seed, monkeypatch)
    assert tn == jn
    ratios = ("mfu_ratio", "hbm_bw_ratio")
    assert {k: v for k, v in ts.items() if k not in ratios} == {
        k: v for k, v in js.items() if k not in ratios}
    assert len(tg) == len(jg)
    for (tm_, th), (jm_, jh) in zip(tg, jg):
        assert math.isclose(tm_ * thw.PEAK_TFLOPS, jm_ * jhw.PEAK_TFLOPS, rel_tol=1e-9, abs_tol=0)
        assert math.isclose(th * thw.PEAK_HBM_GBPS, jh * jhw.PEAK_HBM_GBPS, rel_tol=1e-9,
                            abs_tol=0)


def test_the_port_s_peaks_are_one_h100_s():
    assert (thw.PEAK_TFLOPS, thw.PEAK_INT8_TOPS, thw.PEAK_HBM_GBPS) == (989.0, 1979.0, 3350.0)


def test_an_empty_window_reads_zero(monkeypatch):
    monkeypatch.setattr(ttel.time, "monotonic", lambda: 1.0)
    est = ttel.UtilizationEstimator(matmul_params=1, weight_stream_bytes=1)
    snap = est.snapshot()
    assert snap["mfu_ratio"] == 0.0 and snap["hbm_bw_ratio"] == 0.0
    assert "tokens_per_sec" not in snap
