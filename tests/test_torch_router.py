"""The port's routing tier's pure parts (generativeaiexamples_tpu_torch/router/
{ring,tenants,health,app}.py, the ``router`` config section) against the JAX
package's, on the CPU.

- Ring: owner, full walk and bounded-load spill of 10,000 keys made from a
  numpy seed, over 2-8 replicas, equal to JAX's (the same sha256 points), also
  after a join and a leave; round robin's sequence.
- ``placement_key`` on hypothesis-drawn headers and bodies (derandomized).
- ``parse_tenants``: the same specs, and the same error messages for bad
  ones; the governor: the same decisions (reasons, Retry-After) for one
  seeded sequence of admits, releases and clock steps under one injected
  clock, and the same snapshots and tenant resolution.
- Health: one scripted probe sequence drives both monitors through the
  same transitions, placeable sets and snapshots; passive failures,
  drain, resolve; the default probe over urllib against stdlib stubs gives
  JAX's verdicts (ready, wedged, not ready, the facade fallback, the SLO
  gate, unreachable).
- ``validate_config`` accepts and refuses the same environments with the
  same messages; the router's SLO objective set.
- Route table: the port serves exactly the JAX router app's routes.

Exact comparisons: no tolerance applies."""
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from generativeaiexamples_tpu.router import app as japp
from generativeaiexamples_tpu.router import health as jhealth
from generativeaiexamples_tpu.router import ring as jring
from generativeaiexamples_tpu.router import tenants as jtenants
from generativeaiexamples_tpu_torch.router import app as tapp
from generativeaiexamples_tpu_torch.router import health as thealth
from generativeaiexamples_tpu_torch.router import ring as tring
from generativeaiexamples_tpu_torch.router import tenants as ttenants

KEYS = [f"k{int(v)}-{i}" for i, v in enumerate(np.random.default_rng(0).integers(0, 2**62, 10_000))]


# --------------------------------------------------------------------------- #
# ring


@pytest.mark.parametrize("n", range(2, 9))
def test_ring_owner_walk_and_spill_match_jax(n):
    names = [f"r{i}" for i in range(n)]
    jr, tr = jring.HashRing(names), tring.HashRing(names)
    assert [tring._point(k) for k in KEYS[:100]] == [jring._point(k) for k in KEYS[:100]]
    assert [tr.owner(k) for k in KEYS] == [jr.owner(k) for k in KEYS]
    assert [list(tr.walk(k)) for k in KEYS[:2000]] == [list(jr.walk(k)) for k in KEYS[:2000]]
    # bounded-load spill past a saturated owner, and an ineligible owner
    busy = {names[0], names[-1]}
    jp = jring.AffinityPlacer(jr, saturated=lambda r: r in busy)
    tp = tring.AffinityPlacer(tr, saturated=lambda r: r in busy)
    eligible = names[1:]
    assert ([tp.place(k, eligible) for k in KEYS[:2000]]
            == [tring.Placement(**vars(jp.place(k, eligible))) for k in KEYS[:2000]])
    for ring in (jr, tr):
        ring.add("joiner")
    assert [tr.owner(k) for k in KEYS] == [jr.owner(k) for k in KEYS]
    for ring in (jr, tr):
        ring.remove(names[1])
    assert [tr.owner(k) for k in KEYS] == [jr.owner(k) for k in KEYS]
    assert tr.members() == jr.members() and len(tr) == len(jr)


def test_round_robin_and_empty_ring_match_jax():
    jp, tp = jring.RoundRobinPlacer(), tring.RoundRobinPlacer()
    sets = [["b", "a"], ["a", "b", "c"], [], ["c"]] * 5
    assert ([vars(tp.place(f"k{i}", s)) for i, s in enumerate(sets)]
            == [vars(jp.place(f"k{i}", s)) for i, s in enumerate(sets)])
    assert tring.HashRing().owner("k") is None
    assert vars(tring.AffinityPlacer(tring.HashRing()).place("k", [])) == {
        "replica": None, "outcome": "none"}
    with pytest.raises(ValueError) as je:
        jring.HashRing(vnodes=0)
    with pytest.raises(ValueError) as te:
        tring.HashRing(vnodes=0)
    assert str(te.value) == str(je.value)


# --------------------------------------------------------------------------- #
# placement key

_text = st.text(max_size=12)
_value = st.one_of(st.none(), _text, st.integers(), st.lists(st.one_of(_text, st.integers()),
                                                              max_size=3))
_message = st.one_of(st.dictionaries(st.sampled_from(["role", "content"]), _value, max_size=2),
                     _text, st.none())
_body = st.one_of(
    st.none(), _text, st.lists(_text, max_size=2),
    st.fixed_dictionaries({}, optional={
        "messages": st.one_of(st.lists(_message, max_size=3), _text),
        "prompt": _value, "query": _value, "input": _value}),
)
_headers = st.dictionaries(st.sampled_from(["X-GenAI-Session", "Other"]),
                           st.text(alphabet=" ab\t", max_size=4), max_size=2)


@settings(max_examples=400, deadline=None, derandomize=True)
@given(headers=_headers, body=_body)
def test_placement_key_matches_jax(headers, body):
    assert tapp.placement_key(headers, body) == japp.placement_key(headers, body)


def test_placement_key_long_prompt_head():
    body = {"prompt": "x" * 2000}
    assert tapp.placement_key({}, body) == japp.placement_key({}, body) == "x" * 512


# --------------------------------------------------------------------------- #
# tenants

GOOD_SPECS = [
    "", "default:rate=2,burst=4,inflight=8,weight=2,keys=k1|k2;free:rate=1",
    " a : rate = 0.5 , burst=3 ; b:weight=4;; c:keys=|x||y", "limited:rate=1,burst=1",
]
BAD_SPECS = ["noname:rate=x", ":rate=1", "a:rate=1;a:rate=2", "a:bogus=1", "a:rate",
             "a:weight=0", "a:rate=-1", "a:burst=-2", "a:inflight=-1", "a:inflight=1.5"]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_parse_tenants_matches_jax(spec):
    got = {k: vars(v) for k, v in ttenants.parse_tenants(spec).items()}
    want = {k: vars(v) for k, v in jtenants.parse_tenants(spec).items()}
    assert got == want


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_tenants_refuses_as_jax_does(spec):
    with pytest.raises(ValueError) as je:
        jtenants.parse_tenants(spec)
    with pytest.raises(ValueError) as te:
        ttenants.parse_tenants(spec)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_governor_decisions_match_jax_under_one_clock(seed):
    spec = "default:rate=2,burst=3,inflight=2;hog:weight=1;light:weight=3,keys=lk;slow:rate=0.5"
    clock = [100.0]
    govs = [mod.TenantGovernor(mod.parse_tenants(spec), total_inflight_cap=5,
                               clock=lambda: clock[0]) for mod in (jtenants, ttenants)]
    rng = np.random.default_rng(seed)
    tenants = ["default", "hog", "light", "slow", "anon-1", "anon-2"]
    trace = [[], []]
    for _ in range(400):
        op, tenant = int(rng.integers(0, 3)), tenants[int(rng.integers(0, len(tenants)))]
        if op == 2:
            clock[0] += float(rng.exponential(0.3))
            continue
        for side, gov in enumerate(govs):
            if op == 0:
                d = gov.admit(tenant)
                trace[side].append(None if d is None else (d.reason, d.retry_after_s))
            else:
                gov.release(tenant)
    assert trace[1] == trace[0]
    assert govs[1].snapshot() == govs[0].snapshot()
    for headers in ({"X-GenAI-Tenant": " x "}, {"Authorization": "Bearer lk"},
                    {"Authorization": "bearer  lk "}, {"Authorization": "Bearer no"}, {}):
        assert govs[1].resolve(headers) == govs[0].resolve(headers)


def test_governor_account_table_stays_bounded_as_jax_s():
    clock = [0.0]
    out = []
    for mod in (jtenants, ttenants):
        gov = mod.TenantGovernor(clock=lambda: clock[0])
        gov.admit("pinned")
        for i in range(mod.MAX_ACCOUNTS + 50):
            clock[0] += 0.001
            gov.admit(f"drive-by-{i}")
            gov.release(f"drive-by-{i}")
        out.append(gov.snapshot())
    assert out[1] == out[0] and len(out[1]) <= ttenants.MAX_ACCOUNTS
    assert ttenants.MAX_ACCOUNTS == jtenants.MAX_ACCOUNTS


# --------------------------------------------------------------------------- #
# health


@pytest.mark.parametrize("seed", [0, 1])
def test_health_machine_matches_jax_under_one_scripted_probe(seed):
    rng = np.random.default_rng(seed)
    script = {f"u{i}": [(bool(rng.random() < 0.6), f"d{j}") for j in range(40)] for i in range(3)}
    states = []
    for mod in (jhealth, thealth):
        results = {k: list(v) for k, v in script.items()}
        changes = []
        mon = mod.HealthMonitor(
            {f"r{i}": f"u{i}" for i in range(3)}, fail_threshold=2, ok_threshold=3,
            probe=lambda url, gate: results[url].pop(0),
            on_state_change=lambda rid, state: changes.append((rid, state)))
        trace = []
        for step in range(40):
            mon.poll_once()
            if step == 10:
                mon.note_failure("r1", "connect refused")
                mon.drain("r2")
                mon.begin_request("r0")
                mon.note_queue_depth("r0", 5)
            if step == 20:
                mon.undrain("r2")
                mon.end_request("r0")
                mon.note_queue_depth("r0", -3)
            trace.append((sorted(mon.placeable()), mon.total_inflight(), mon.queue_depth("r0"),
                          {k: {f: v for f, v in s.items()} for k, s in mon.snapshot().items()}))
        states.append((trace, changes, [mon.resolve(t) for t in ("r1", "u2", "nope", "u0/")]))
    assert states[1] == states[0]
    assert thealth.HEALTHY == jhealth.HEALTHY and thealth.UNHEALTHY == jhealth.UNHEALTHY


class _ProbeStub(BaseHTTPRequestHandler):
    """Answers /internal/ready, /v1/health/ready and /internal/slo from
    the server's ``answers`` table (path -> (status, body or None))."""

    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def do_GET(self):  # noqa: N802
        status, body = self.server.answers.get(urllib.parse.urlsplit(self.path).path, (404, None))
        data = b"not json" if body is None else json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


CASES = {
    "ready": {"/internal/ready": (200, {"ready": True, "wedged": False})},
    "wedged": {"/internal/ready": (503, {"ready": False, "wedged": True})},
    "not_ready": {"/internal/ready": (200, {"ready": False})},
    "not_json": {"/internal/ready": (500, None)},
    "facade_ready": {"/v1/health/ready": (200, {"object": "health", "message": "ok"})},
    "facade_wedged": {"/v1/health/ready": (503, {"object": "health"})},
    "slo_unmet": {"/internal/ready": (200, {"ready": True}),
                  "/internal/slo": (200, {"all_met": False})},
    "slo_absent": {"/internal/ready": (200, {"ready": True})},
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("gate", [False, True])
def test_default_probe_gives_jax_s_verdicts(case, gate, monkeypatch):
    server = ThreadingHTTPServer(("127.0.0.1", 0), _ProbeStub)
    server.daemon_threads = True
    server.answers = CASES[case]
    threading.Thread(target=server.serve_forever, name="probe-stub", daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert thealth._default_probe(url, gate) == jhealth._default_probe(url, gate)
    finally:
        server.shutdown()
        server.server_close()


def test_default_probe_unreachable_matches_jax():
    got = thealth._default_probe("http://127.0.0.1:9", False)
    want = jhealth._default_probe("http://127.0.0.1:9", False)
    assert got[0] is want[0] is False
    assert got[1].startswith("unreachable: ") and want[1].startswith("unreachable: ")


# --------------------------------------------------------------------------- #
# config


ENV_CASES = [
    {}, {"APP_ROUTER_POLICY": "random"}, {"APP_ROUTER_RINGVNODES": "0"},
    {"APP_ROUTER_LOADBOUND": "0.5"}, {"APP_ROUTER_LOADBOUND": "-1"},
    {"APP_ROUTER_LOADBOUND": "0"}, {"APP_ROUTER_SPILLQUEUEDEPTH": "-1"},
    {"APP_ROUTER_FAILOVERRETRY": "maybe"}, {"APP_ROUTER_HEALTHSLOGATE": "yes"},
    {"APP_ROUTER_RETRYBUDGET": "-1"}, {"APP_ROUTER_HEALTHINTERVALS": "0"},
    {"APP_ROUTER_HEALTHFAILTHRESHOLD": "0"}, {"APP_ROUTER_HEALTHOKTHRESHOLD": "0"},
    {"APP_ROUTER_MAXINFLIGHT": "-2"}, {"APP_ROUTER_CONNECTTIMEOUTS": "0"},
    {"APP_ROUTER_READTIMEOUTS": "-1"}, {"APP_ROUTER_TENANTS": "a:bogus=1"},
    {"APP_ROUTER_REPLICAS": "http://a:1, host-b:2"},
    {"APP_ROUTER_REPLICAS": "http://a:1,http://b:2", "APP_ROUTER_POLICY": "round_robin",
     "APP_ROUTER_TENANTS": "limited:rate=1,burst=1"},
]


@pytest.mark.parametrize("env", ENV_CASES, ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items())
                         or "defaults")
def test_validate_config_matches_jax(env, clean_app_env):
    from generativeaiexamples_tpu.config import AppConfig as JAppConfig
    from generativeaiexamples_tpu_torch.config import AppConfig as TAppConfig

    for key, value in env.items():
        clean_app_env.setenv(key, value)
    jcfg, tcfg = JAppConfig.from_dict({}), TAppConfig.from_env()
    assert {f: getattr(tcfg.router, f) for f in vars(tcfg.router)} == {
        f: getattr(jcfg.router, f) for f in vars(tcfg.router)}
    try:
        japp.validate_config(jcfg)
        want = None
    except ValueError as exc:
        want = str(exc)
    try:
        tapp.validate_config(tcfg)
        got = None
    except ValueError as exc:
        got = str(exc)
    assert got == want
    assert (want is None) == (env in ENV_CASES[:1] + ENV_CASES[-1:] + [{"APP_ROUTER_LOADBOUND": "0"}])


def test_router_config_fields_are_jax_s():
    from generativeaiexamples_tpu.config.schema import RouterConfig as JRouterConfig
    from generativeaiexamples_tpu_torch.config import RouterConfig as TRouterConfig

    import dataclasses

    j = {f.name: f.default for f in dataclasses.fields(JRouterConfig)}
    t = {f.name: f.default for f in dataclasses.fields(TRouterConfig)}
    assert t == j and len(t) == 15


def test_create_router_installs_the_router_slo_set(clean_app_env):
    """The router process evaluates proxy_overhead_p95 and failover_rate
    (JAX's ``configure_router``), validated first."""
    from generativeaiexamples_tpu_torch.config import AppConfig
    from generativeaiexamples_tpu_torch.utils import slo as tslo

    try:
        router = tapp.create_router(AppConfig.from_env(), replica_urls=["http://127.0.0.1:9"])
        tracker = tslo.get_tracker()
        assert set(tracker.latency_objectives) | set(tracker.rate_events) == {
            "proxy_overhead_p95", "failover_rate"}
        assert sorted(router.replicas) == ["r0"]
        clean_app_env.setenv("APP_ROUTER_POLICY", "random")
        with pytest.raises(ValueError, match="router.policy"):
            tapp.create_router(AppConfig.from_env(), replica_urls=["http://127.0.0.1:9"])
        clean_app_env.delenv("APP_ROUTER_POLICY")
        with pytest.raises(ValueError, match="at least one replica"):
            tapp.create_router(AppConfig.from_env())
    finally:
        tslo.reset()


# --------------------------------------------------------------------------- #
# routes


def test_route_table_is_the_jax_router_s(clean_app_env):
    from generativeaiexamples_tpu.config import AppConfig

    app = japp.RouterServer(AppConfig.from_dict({}), ["http://127.0.0.1:9"]).build_app()
    jax_routes = {(r.method, r.resource.canonical) for r in app.router.routes()
                  if r.method != "HEAD"}
    assert set(tapp.ROUTE_TABLE) == jax_routes
    assert len(tapp.ROUTE_TABLE) == len(jax_routes) == 27
    assert tapp.POLICIES == japp.POLICIES
    for name in ("_FORWARD_HEADERS", "_RESPONSE_HEADERS", "_RETRYABLE_STATUSES",
                 "QUEUE_DEPTH_HEADER", "REPLICA_HEADER", "RESTORE_HEADER", "SESSION_HEADER"):
        assert getattr(tapp, name) == getattr(japp, name), name
