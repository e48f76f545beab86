"""``parallel/multihost.py`` and ``tools/launch.py`` against the JAX
package's multihost helpers (tests/test_multihost.py's cases):

- the env contract (``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/
  ``PROCESS_ID``), the precedence of explicit arguments and the no-op,
  with ``init_process_group`` (and JAX's ``jax.distributed.initialize``)
  monkeypatched: both packages parse the same call;
- the backend choice (``nccl`` only where every process owns a card, on
  one host and on two), from the hosts the processes trade before the
  group forms;
- ``create_hybrid_mesh``'s shapes and ``local_batch_slice`` against JAX's
  functions on conftest's 8 virtual devices;
- a real 2-process ``gloo`` group under ``torch.multiprocessing`` (an
  all-reduce and a barrier), a group whose peer dies, and a rendezvous
  whose peer never comes: each raises, none hangs (each group holds a
  60 s limit of its own, tests/torch_group_workers.py);
- the launcher: the contract in every child, a failing child stops the
  others and gives its exit code.
"""
import datetime
import sys
import time

import jax
import pytest
import torch

from generativeaiexamples_tpu.parallel import multihost as jmh
from generativeaiexamples_tpu.parallel.mesh import create_mesh as jcreate_mesh
from generativeaiexamples_tpu_torch.parallel import create_mesh, multihost
from generativeaiexamples_tpu_torch.tools import launch
from tests import torch_group_workers as workers


@pytest.fixture
def fake_init(monkeypatch):
    """Both packages' initializers captured instead of run (the port's
    trade of hosts too: every process on one host without a card)."""
    seen = {"jax": {}, "port": {}}
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: seen["jax"].update(kw))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: seen["port"].update(kw))

    def trade(address, n, rank, timeout_s):
        seen["traded"] = (address, n, rank)
        return [("host", 0)] * n

    monkeypatch.setattr(multihost, "_trade_hosts", trade)
    monkeypatch.setattr(multihost, "_BACKEND", None)
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    return seen


def _port_call(address, n, rank):
    return {"backend": "gloo", "init_method": f"tcp://{address}", "world_size": n, "rank": rank,
            "timeout": datetime.timedelta(seconds=multihost.DEFAULT_TIMEOUT_S)}


def test_initialize_is_a_no_op_without_a_coordinator(fake_init):
    assert multihost.initialize_distributed() is jmh.initialize_distributed() is False
    assert fake_init == {"jax": {}, "port": {}}
    assert multihost.backend() is None
    assert (multihost.process_count(), multihost.process_index()) == (1, 0)


def test_initialize_reads_the_env_contract(fake_init, monkeypatch):
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.5:8476")
    monkeypatch.setenv("NUM_PROCESSES", "4")
    monkeypatch.setenv("PROCESS_ID", "2")
    assert multihost.initialize_distributed() is jmh.initialize_distributed() is True
    assert fake_init["jax"] == {"coordinator_address": "10.0.0.5:8476", "num_processes": 4,
                                "process_id": 2}
    assert fake_init["port"] == _port_call("10.0.0.5:8476", 4, 2)
    assert fake_init["traded"] == ("10.0.0.5:8476", 4, 2)
    assert multihost.backend() == "gloo"  # no card here


def test_explicit_arguments_beat_the_env(fake_init, monkeypatch):
    monkeypatch.setenv("COORDINATOR_ADDRESS", "env-host:1")
    monkeypatch.setenv("NUM_PROCESSES", "8")
    monkeypatch.setenv("PROCESS_ID", "7")
    # an explicit process_id=0 must not fall back to the env value
    assert multihost.initialize_distributed("arg-host:2", num_processes=2, process_id=0) is True
    assert jmh.initialize_distributed("arg-host:2", num_processes=2, process_id=0) is True
    assert fake_init["jax"] == {"coordinator_address": "arg-host:2", "num_processes": 2,
                                "process_id": 0}
    assert fake_init["port"] == _port_call("arg-host:2", 2, 0)


def test_one_process_under_a_coordinator_joins_and_reports_false(fake_init, monkeypatch):
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:9999")
    assert multihost.initialize_distributed() is jmh.initialize_distributed() is False
    assert fake_init["jax"]["num_processes"] == fake_init["port"]["world_size"] == 1
    assert fake_init["jax"]["process_id"] == fake_init["port"]["rank"] == 0


@pytest.mark.parametrize("cards,n,want", [(0, 2, "gloo"), (1, 2, "gloo"), (1, 1, "nccl"),
                                          (2, 2, "nccl"), (4, 2, "nccl"), (2, 4, "gloo")])
def test_nccl_only_where_every_process_owns_a_card(monkeypatch, cards, n, want):
    """NCCL refuses two ranks on one device, so processes sharing a card
    (or the CPU) run gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert multihost.choose_backend([("host", cards)] * n) == want
    if cards:
        assert [multihost.local_device(r) for r in range(n)] == [
            torch.device("cuda", r % cards) for r in range(n)]


@pytest.mark.parametrize("hosts,want", [
    ([("a", 8)] * 8 + [("b", 8)] * 8, "nccl"),  # 16 processes on two 8-card hosts
    ([("a", 8)] * 4 + [("b", 8)] * 4, "nccl"),
    ([("a", 8)] * 8 + [("b", 8)] * 9, "gloo"),  # host b runs one process more than its cards
    ([("a", 8)] * 8 + [("b", 0)] * 2, "gloo"),  # host b has no card
    ([("a", 1), ("b", 1)], "nccl"),
])
def test_the_backend_counts_the_processes_of_each_host(hosts, want):
    """The world size is not this host's process count: on two hosts each
    process owns a card wherever no host runs more processes than cards."""
    assert multihost.choose_backend(hosts) == want



@pytest.mark.parametrize("kwargs", [
    {}, dict(dcn_data_parallelism=1, ici_tensor_parallelism=4, ici_seq_parallelism=2),
    dict(dcn_data_parallelism=1, ici_tensor_parallelism=8), dict(ici_seq_parallelism=2),
    dict(ici_seq_parallelism=8, ici_tensor_parallelism=1), dict(ici_seq_parallelism=4),
])
def test_hybrid_mesh_shapes_are_jax_s(kwargs):
    """One process: the plain local mesh over its devices, JAX's shapes."""
    want = jmh.create_hybrid_mesh(**kwargs)
    got = multihost.create_hybrid_mesh(**kwargs, devices=["cpu"] * len(jax.devices()))
    assert got.shape == dict(want.shape) and got.processes == 1


def test_hybrid_mesh_over_processes_puts_a_granule_on_the_outer_axes(monkeypatch):
    """Four processes of two devices each: one data replica a process,
    each process's devices its (seq, model) mesh, JAX's -1 rules."""
    monkeypatch.setattr(multihost, "process_count", lambda: 4)
    devices = [torch.device("cpu", i) for i in range(8)]
    mesh = multihost.create_hybrid_mesh(devices=devices)
    assert mesh.shape == {"pipe": 1, "data": 4, "seq": 1, "model": 2} and mesh.processes == 4
    assert [mesh.replica(d).devices for d in range(4)] == [devices[2 * d:2 * d + 2] for d in range(4)]
    assert [mesh.process_replicas(r) for r in range(4)] == [[0], [1], [2], [3]]
    seq = multihost.create_hybrid_mesh(ici_seq_parallelism=2, devices=devices)
    assert seq.shape == {"pipe": 1, "data": 4, "seq": 2, "model": 1}
    with pytest.raises(ValueError, match="does not tile"):
        multihost.create_hybrid_mesh(dcn_data_parallelism=2, devices=devices)


def test_local_batch_slice_is_jax_s(monkeypatch):
    jmesh = jmh.create_hybrid_mesh(dcn_data_parallelism=1, ici_tensor_parallelism=8)
    mesh = multihost.create_hybrid_mesh(dcn_data_parallelism=1, ici_tensor_parallelism=8,
                                        devices=["cpu"] * 8)
    assert multihost.local_batch_slice(32, mesh) == jmh.local_batch_slice(32, jmesh) == 32
    jdata2 = jcreate_mesh(tensor_parallelism=4, data_parallelism=2)
    data2 = create_mesh(4, 2, devices=["cpu"] * 8)
    for mod, m in ((jmh, jdata2), (multihost, data2)):
        with pytest.raises(ValueError, match="not divisible") as exc:
            mod.local_batch_slice(3, m)
        assert str(exc.value) == "global batch 3 not divisible by 2"
    # a four-process pod: global / process count, the guard over data x pipe
    jdata4 = jcreate_mesh(tensor_parallelism=2, data_parallelism=4)
    data4 = create_mesh(2, 4, devices=["cpu"] * 8)
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    monkeypatch.setattr(multihost, "process_count", lambda: 4)
    assert multihost.local_batch_slice(32, data4) == jmh.local_batch_slice(32, jdata4) == 8
    with pytest.raises(ValueError, match="not divisible"):
        multihost.local_batch_slice(30, data4)


def test_two_processes_join_a_gloo_group_and_all_reduce():
    results, seconds = workers.run_group(workers.group_worker, 2)
    assert {r: s for r, (s, _) in results.items()} == {0: "ok", 1: "ok"}, results
    for rank, (_, out) in results.items():
        assert out["backend"] == "gloo" and out["count"] == 2 and out["index"] == rank
        assert out["device"] == "cpu" and out["sum"] == [3.0, 3.0, 3.0]
    assert seconds < workers.GROUP_LIMIT_S


def test_a_dead_peer_raises_in_the_survivor_and_nothing_hangs():
    """Rank 1 exits right after joining: rank 0's all-reduce raises (no
    hang, no silent success) well inside the group's timeout."""
    results, seconds = workers.run_group(workers.group_worker, 2, 1, expect=1)
    status, payload = results[0]
    assert status == "error", payload
    assert seconds < 30.0


def test_a_rendezvous_whose_peer_never_comes_raises():
    """Rank 0 of a group of two whose rank 1 never starts: its
    ``init_process_group`` raises at the timeout (3 s here)."""
    results, seconds = workers.run_group(workers.lone_worker, 1, 3.0)
    status, payload = results[0]
    assert status == "error" and "init_process_group" in payload, payload
    assert seconds < 30.0


def _child(tmp_path, name, body):
    (tmp_path / f"{name}.py").write_text(body)
    return name


def test_the_launcher_sets_the_contract_in_every_child(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", f"{tmp_path}")
    mod = _child(tmp_path, "contract_child", (
        "import os, sys\n"
        "out = os.path.join(sys.argv[1], 'rank' + os.environ['PROCESS_ID'])\n"
        "open(out, 'w').write(' '.join(os.environ[k] for k in "
        "('COORDINATOR_ADDRESS', 'NUM_PROCESSES', 'PROCESS_ID')) + ' ' + ' '.join(sys.argv[2:]))\n"))
    assert launch.main(["--nproc", "3", "--", mod, str(tmp_path), "--x", "1"]) == 0
    seen = [(tmp_path / f"rank{i}").read_text().split() for i in range(3)]
    address = seen[0][0]
    assert address.startswith("127.0.0.1:") and int(address.rsplit(":", 1)[1]) > 0
    assert seen == [[address, "3", str(i), "--x", "1"] for i in range(3)]


def test_a_failing_child_fails_the_launch_and_stops_the_others(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", f"{tmp_path}")
    mod = _child(tmp_path, "failing_child", (
        "import os, sys, time\n"
        "if os.environ['PROCESS_ID'] == '1':\n"
        "    sys.exit(3)\n"
        "time.sleep(60)\n"
        "open(os.path.join(sys.argv[1], 'survived'), 'w').write('yes')\n"))
    start = time.monotonic()
    assert launch.main(["--nproc", "2", mod, str(tmp_path)]) == 3
    assert time.monotonic() - start < 30.0
    assert not (tmp_path / "survived").exists()


def test_the_launcher_runs_the_finetune_cli_in_two_processes(tmp_path):
    """The CLI under the launcher: two processes, ``--dp 2`` over gloo,
    rank 0 alone prints the last line."""
    import subprocess

    data = tmp_path / "d.jsonl"
    data.write_text("\n".join('{"prompt": "q%d: a gpu?", "response": "a card"}' % i for i in range(4)))
    out = subprocess.run(
        [sys.executable, "-m", "generativeaiexamples_tpu_torch.tools.launch", "--nproc", "2", "--",
         "generativeaiexamples_tpu_torch.tools.finetune", "--model", "debug", "--data", str(data),
         "--mode", "lora", "--rank", "2", "--steps", "2", "--batch-size", "2", "--seq-len", "16",
         "--dp", "2", "--device", "cpu", "--log-every", "1"],
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [l for l in out.stdout.splitlines() if l.strip()]
    assert len(lines) == 1 and '"steps": 2' in lines[0]
    assert out.stderr.count('"backend": "gloo"') == 2
