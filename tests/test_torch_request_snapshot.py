"""The port's snapshot document and spool (generativeaiexamples_tpu_torch/engine/request_snapshot.py)
against the JAX package's (generativeaiexamples_tpu/engine/request_snapshot.py):

- random KV payloads of the three pool dtypes' page shapes (bf16 k/v;
  int8 k/v with f32 scale planes; int4 as uint8 ``[..., Dh // 2]`` with
  scales) encode to equal JSON in both codecs, and each decodes the
  other's bitwise (exact: bytes are compared);
- ``to_doc`` writes JAX's fields and values, ``from_doc`` reads JAX's
  documents, ``sampling_params`` pins the seed;
- the spool evicts the oldest past ``max_entries`` and lists as JAX's;
- geometry and fingerprint refusals raise ``SnapshotMismatch`` with JAX's
  messages; the config fingerprint is JAX's function of a dataclass.
"""
import json
import os
import types

import ml_dtypes
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.engine import request_snapshot as jsnap
from generativeaiexamples_tpu.utils import provenance as jprov
from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import request_snapshot as tsnap

PAGES, PAGE, HKV, DH, LAYERS = 3, 8, 2, 16, 2


def _payload(kind: str, seed: int):
    """One payload as (numpy layers for JAX, torch layers for the port)."""
    rng = np.random.default_rng(seed)
    shape = (PAGES, PAGE, HKV, DH)
    jl, tl = [], []
    for _ in range(LAYERS):
        if kind == "bfloat16":
            arrs = {k: rng.standard_normal(shape).astype(ml_dtypes.bfloat16) for k in "kv"}
        else:
            qshape = shape[:3] + (DH // 2,) if kind == "int4" else shape
            qdtype = np.uint8 if kind == "int4" else np.int8
            info = np.iinfo(qdtype)
            arrs = {k: rng.integers(info.min, info.max + 1, qshape).astype(qdtype) for k in "kv"}
            arrs.update({k: rng.random(shape[:3]).astype(np.float32) for k in ("ks", "vs")})
        jl.append(arrs)
        tl.append({k: torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                   if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a.copy())
                   for k, a in arrs.items()})
    return jl, tl


def _bytes(t) -> bytes:
    if isinstance(t, np.ndarray):
        return np.ascontiguousarray(t).tobytes()
    t = t.contiguous()
    return (t.view(torch.uint8) if t.element_size() > 1 else t).numpy().tobytes()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", ["bfloat16", "int8", "int4"])
def test_payload_codecs_write_equal_json_and_read_each_other_bitwise(kind, seed):
    jl, tl = _payload(kind, seed)
    jdoc, tdoc = jsnap.encode_kv_payload(jl), tsnap.encode_kv_payload(tl)
    assert json.dumps(jdoc, sort_keys=True) == json.dumps(tdoc, sort_keys=True)
    from_jax = tsnap.decode_kv_payload(jdoc)
    from_port = jsnap.decode_kv_payload(tdoc)
    for j, t, a, b in zip(jl, tl, from_jax, from_port):
        assert set(j) == set(t) == set(a) == set(b)
        for key in j:
            assert a[key].dtype == t[key].dtype and tuple(a[key].shape) == j[key].shape
            assert b[key].dtype == j[key].dtype and b[key].shape == j[key].shape
            assert _bytes(a[key]) == _bytes(j[key]) == _bytes(b[key]) == _bytes(t[key])


def _snap_fields():
    jl, tl = _payload("int8", 7)
    common = dict(snapshot_id="snap-7-abc", rid=7, prompt_ids=[1, 2, 3], emitted=[9, 8],
                  position=4, sampling_seed=1234, geometry={"page_size": PAGE, "pages": PAGES},
                  config_fingerprint="0123456789ab", created_at=1.5)
    params = types.SimpleNamespace(temperature=0.7, top_p=0.9, max_tokens=16, stop=("x",),
                                   seed=0, prefix_hint="h", spec_decode=None)
    return common, params, jl, tl


def test_to_doc_has_jax_s_fields_and_values():
    common, params, jl, tl = _snap_fields()
    j = jsnap.RequestSnapshot(params=jsnap.params_doc(params), kv=jsnap.encode_kv_payload(jl),
                              **common)
    t = tsnap.RequestSnapshot(params=tsnap.params_doc(params), kv=tsnap.encode_kv_payload(tl),
                              **common)
    jdoc, tdoc = j.to_doc(), t.to_doc()
    assert list(jdoc) == list(tdoc)
    jdoc.pop("provenance"), tdoc.pop("provenance")
    assert json.dumps(jdoc, sort_keys=True) == json.dumps(tdoc, sort_keys=True)
    back = tsnap.RequestSnapshot.from_doc(j.to_doc())
    assert (back.emitted, back.position, back.restorable) == ([9, 8], 4, True)
    sp = back.sampling_params()
    assert (sp.seed, sp.temperature, sp.top_p, sp.max_tokens, sp.stop, sp.prefix_hint) == \
        (1234, 0.7, 0.9, 16, ("x",), "h")
    with pytest.raises(tsnap.SnapshotMismatch, match="snapshot version 2 is not 1"):
        tsnap.RequestSnapshot.from_doc({**j.to_doc(), "version": 2})


def test_spool_evicts_the_oldest_and_lists_as_jax_s(tmp_path):
    common, params, jl, tl = _snap_fields()
    spools = (jsnap.SnapshotSpool(str(tmp_path / "j"), 3, fingerprint="f"),
              tsnap.SnapshotSpool(str(tmp_path / "t"), 3, fingerprint="f"))
    for i in range(5):
        fields = dict(common, snapshot_id=f"snap-{i}", rid=i, created_at=10.0 + i)
        for spool, mod, layers in zip(spools, (jsnap, tsnap), (jl, tl)):
            snap = mod.RequestSnapshot(params=mod.params_doc(params),
                                       kv=mod.encode_kv_payload(layers) if i % 2 else None,
                                       **fields)
            path = spool.save(snap)
            os.utime(path, (100.0 + i, 100.0 + i))  # a clear age order
    jlist, tlist = (spool.list() for spool in spools)
    assert [e["snapshot_id"] for e in tlist] == ["snap-4", "snap-3", "snap-2"]
    assert tlist == jlist
    assert spools[1].load_doc("snap-3") == spools[0].load_doc("snap-3")
    with pytest.raises(tsnap.SnapshotError, match="snapshot 'snap-0' not in spool"):
        spools[1].load_doc("snap-0")
    assert tsnap.SnapshotSpool(str(tmp_path / "none")).list() == []


def _engine_ns(kv_dtype="int8", page=PAGE):
    return types.SimpleNamespace(
        _kv_quant=kv_dtype != "bfloat16", _kv_packed=kv_dtype == "int4",
        engine_config=types.SimpleNamespace(page_size=page),
        model_config=types.SimpleNamespace(num_layers=LAYERS, num_kv_heads=HKV, head_dim=DH),
    )


@pytest.mark.parametrize("snap_kv,engine_kv,page,legacy", [
    ("int8", "int4", PAGE, False), ("int4", "int8", PAGE, False), ("bfloat16", "int8", PAGE, False),
    ("int8", "int8", 16, False), ("int8", "int4", PAGE, True), ("int8", "int8", PAGE, True),
])
def test_geometry_refusals_are_jax_s(snap_kv, engine_kv, page, legacy):
    geometry = {"page_size": PAGE, "pages": PAGES, "quantized": snap_kv != "bfloat16",
                "kv_dtype": snap_kv, "num_layers": LAYERS, "num_kv_heads": HKV, "head_dim": DH}
    if legacy:
        geometry.pop("kv_dtype")
    outcomes = []
    for mod in (jsnap, tsnap):
        snap = mod.RequestSnapshot(snapshot_id="s", rid=1, prompt_ids=[1], emitted=[2],
                                   position=1, sampling_seed=3, params={}, geometry=geometry,
                                   kv={"layers": []})
        try:
            mod.check_geometry(_engine_ns(engine_kv, page), snap)
            outcomes.append(None)
        except mod.SnapshotMismatch as exc:
            outcomes.append(str(exc))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1] is None) == (legacy and engine_kv == "int8")


def test_fingerprint_refusal_and_the_fingerprint_function(tmp_path):
    cfg = EngineConfig(model_config_name="debug")
    fp = tsnap.config_fingerprint(cfg)
    assert fp == jprov.config_fingerprint(cfg) and len(fp) == 12
    assert tsnap.config_fingerprint(EngineConfig(model_config_name="debug",
                                                 kv_cache_dtype="int8")) != fp
    spool = tsnap.SnapshotSpool(str(tmp_path), fingerprint=fp)
    snap = tsnap.RequestSnapshot(snapshot_id="s", rid=1, prompt_ids=[1], emitted=[], position=0,
                                 sampling_seed=3, params={}, config_fingerprint="ffffffffffff")
    with pytest.raises(tsnap.SnapshotMismatch, match="refusing to restore"):
        spool.check_fingerprint(snap)
    snap.config_fingerprint = fp
    spool.check_fingerprint(snap)
    snap.config_fingerprint = None  # a document with no stamp is not refused
    spool.check_fingerprint(snap)
