"""The port's trace stitching (generativeaiexamples_tpu_torch/utils/trace_stitch.py)
against the JAX package's (generativeaiexamples_tpu/utils/trace_stitch.py):
the same trace-id normalization, the same merged document for the same
per-process timelines (drawn from a numpy seed: sources with their own
start times, events, missing and malformed sources), and the same
richest-record choice. Exact comparisons: no tolerance applies."""
import numpy as np
import pytest

from generativeaiexamples_tpu.utils import trace_stitch as js
from generativeaiexamples_tpu_torch.utils import trace_stitch as ts

IDS = ["4BF92F3577B34DA6A3CE929D0E0E4736", " 4bf92f3577b34da6a3ce929d0e0e4736 ", "0" * 32,
       "xyz", "", None, "4bf92f3577b34da6a3ce929d0e0e473", "g" * 32, "a" * 32]


@pytest.mark.parametrize("raw", IDS)
def test_normalize_trace_id_is_jax_s(raw):
    assert ts.normalize_trace_id(raw) == js.normalize_trace_id(raw)


def _sources(seed):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(int(rng.integers(0, 5))):
        if rng.integers(0, 6) == 0:
            out.append((f"src{s}", None))
            continue
        events = [{"t_s": round(float(rng.uniform(0, 2)), 6), "event": f"e{k}", "k": k}
                  for k in range(int(rng.integers(0, 6)))]
        tl = {"request_id": f"r{s}", "trace_id": "ab" * 16,
              "started_at": 1_700_000_000.0 + float(rng.uniform(0, 1)), "outcome": "finish",
              "ttft_s": 0.1, "total_s": 0.5, "done": True, "timeline": events}
        if rng.integers(0, 4) == 0:
            tl.pop("timeline")
            tl["events"] = int(rng.integers(0, 9))
        out.append((f"src{s}", tl))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_merge_and_pick_are_jax_s(seed):
    sources = _sources(seed)
    assert ts.merge_timelines(sources) == js.merge_timelines(sources)
    cands = [tl for _, tl in sources if tl]
    assert ts.pick_richest(cands) == js.pick_richest(cands)
    for tl in cands:
        assert ts.richness(tl) == js.richness(tl)
