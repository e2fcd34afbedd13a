"""The port's command-line tools against the JAX package's.

One seeded 24-node cluster runs through each package's ``DhtNetwork``
(``os.urandom`` and the global ``random`` drawing from one seeded
stream); ``dhtnode``'s ``format_stats`` and ``format_dump`` and the
gateway's ``node_stats_json`` over node 0 give equal text, and the
scanner's crawl of the cluster (driven on the virtual clock) finds the
same nodes with the same metrics.  Then each tool runs as
``python -m opendht_tpu_torch.tools.<name>`` on loopback: ``dhtnode``
scripted over stdin, ``dhtchat``, ``dhtscanner`` and ``http_gateway``
(a POST, a GET, ``/metrics`` and ``/stats.json``, answered as the JAX
gateway answers)."""

import json
import os
import random
import select
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import pytest

import opendht_tpu.core.value as jv
import opendht_tpu.harness.network as jnet
import opendht_tpu.runtime.dhtrunner as jdr
import opendht_tpu.tools.dhtnode as jnode
import opendht_tpu.tools.dhtscanner as jscan
import opendht_tpu.tools.http_gateway as jgw
import opendht_tpu.utils.infohash as jih
import opendht_tpu.utils.metrics as jmet
import opendht_tpu.utils.sockaddr as jsa
import opendht_tpu_torch.core.value as tv
import opendht_tpu_torch.harness.network as tnet
import opendht_tpu_torch.runtime.dhtrunner as tdr
import opendht_tpu_torch.tools.dhtnode as tnode
import opendht_tpu_torch.tools.dhtscanner as tscan
import opendht_tpu_torch.tools.http_gateway as tgw
import opendht_tpu_torch.utils.infohash as tih
import opendht_tpu_torch.utils.metrics as tmet
import opendht_tpu_torch.utils.sockaddr as tsa
from opendht_tpu_torch.tools.common import parse_host_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": dict(net=jnet, v=jv, ih=jih, dr=jdr, node=jnode, scan=jscan,
                    gw=jgw, met=jmet, sa=jsa),
        "port": dict(net=tnet, v=tv, ih=tih, dr=tdr, node=tnode, scan=tscan,
                     gw=tgw, met=tmet, sa=tsa)}


def seed_draws(monkeypatch, seed=99):
    stream = random.Random(seed)
    monkeypatch.setattr(os, "urandom", lambda n: stream.randbytes(n))
    random.seed(seed + 1)


def scan_on_clock(scanner, net, IH, timeout=600.0):
    """``Scanner.scan``'s two root searches, with the cluster's virtual
    clock driven until every split search is done (``scan`` itself
    blocks on a thread event, which nothing would set here)."""
    with scanner.lock:
        scanner.pending += 1
    for bit in (False, True):
        scanner.step(IH.InfoHash.get_random().set_bit(0, bit), 0)
    with scanner.lock:
        scanner.pending -= 1
        if scanner.pending == 0:
            scanner.done_evt.set()
    return net.run_until(scanner.done_evt.is_set, timeout)


def run_tools(pkg, monkeypatch):
    P = PKGS[pkg]
    seed_draws(monkeypatch)
    net = P["net"].DhtNetwork(24, seed=3)
    net.interconnect()
    net.run(5.0)
    done = []
    for i in range(6):
        net.nodes[i].put(P["ih"].InfoHash.get(f"tool-{i}"),
                         P["v"].Value(f"value {i}".encode()),
                         lambda ok, ns: done.append(ok))
    assert net.run_until(lambda: len(done) == 6, 30)
    net.nodes[0].listen(P["ih"].InfoHash.get("tool-1"), lambda vs: True)
    net.nodes[0].get(P["ih"].InfoHash.get("tool-2"), lambda vs: True)
    net.run(2.0)
    view = P["dr"].DhtRunner()       # the runner's introspection, no loop
    view.dht = net.nodes[0]
    out = {"stats": P["node"].format_stats(view),
           "dump": P["node"].format_dump(view),
           "json": P["gw"].node_stats_json(view)}
    reg = P["met"].MetricsRegistry()
    sc = P["scan"].Scanner(net.nodes[5], reg)
    assert scan_on_clock(sc, net, P["ih"])
    out["seen"] = sorted((bytes(k), str(a)) for k, a in sc.seen.items())
    out["scan_metrics"] = reg.render_prometheus()
    return out


@pytest.fixture(scope="module")
def tool_runs():
    mp = pytest.MonkeyPatch()
    try:
        return {pkg: run_tools(pkg, mp) for pkg in PKGS}
    finally:
        mp.undo()


@pytest.mark.parametrize("what", ["stats", "dump", "json", "seen",
                                  "scan_metrics"])
def test_tool_output_equal(tool_runs, what):
    assert tool_runs["port"][what] == tool_runs["jax"][what]


def test_tool_output_shape(tool_runs):
    t = tool_runs["port"]
    assert "storage:" in t["stats"] and "messages (in/out)" in t["stats"]
    assert "--- routing table IPv4 ---" in t["dump"]
    assert "--- storage ---" in t["dump"] and "--- searches ---" in t["dump"]
    assert t["json"]["ipv4"]["good_nodes"] > 0
    assert json.loads(json.dumps(t["json"])) == t["json"]
    assert len(t["seen"]) >= 20          # the crawl found the cluster
    assert "dht_scanner_nodes_discovered_total" in t["scan_metrics"]


def test_parse_host_port():
    assert parse_host_port("10.0.0.1:5000") == ("10.0.0.1", 5000)
    assert parse_host_port("host") == ("host", 4222)
    assert parse_host_port("[::1]:7") == ("::1", 7)
    assert parse_host_port("[::1]") == ("::1", 4222)


# ---------------------------------------------------------------------------
# the tools as programs, on loopback
# ---------------------------------------------------------------------------

def _tool(name, *args):
    proc = subprocess.Popen(
        [sys.executable, "-m", f"opendht_tpu_torch.tools.{name}", *args],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, cwd=ROOT, text=True, bufsize=1)
    proc.pending = b""
    return proc


def _read_until(proc, needle, timeout=15.0):
    """Lines of ``proc``'s output up to the first holding ``needle``
    (read from the pipe's descriptor, so that no line waits in a
    buffer that ``select`` cannot see)."""
    lines, end = [], time.monotonic() + timeout
    fd = proc.stdout.fileno()
    while time.monotonic() < end:
        while b"\n" in proc.pending:
            line, proc.pending = proc.pending.split(b"\n", 1)
            lines.append(line.decode() + "\n")
            if needle in lines[-1]:
                return lines
        r, _, _ = select.select([fd], [], [], 0.1)
        if r:
            chunk = os.read(fd, 65536)
            if not chunk:
                break
            proc.pending += chunk
    raise AssertionError(f"{needle!r} not seen in {lines}")


@pytest.fixture()
def peer():
    """A JAX runner on 127.0.0.1 for the tools to bootstrap from."""
    r = jdr.DhtRunner()
    r.run(port=0, bind4="127.0.0.1")
    yield r
    r.join()


def test_dhtnode_repl_over_stdin(peer):
    proc = _tool("dhtnode", "-p", "0", "--bind", "127.0.0.1", "-b",
                 f"127.0.0.1:{peer.get_bound_port()}")
    try:
        assert "OpenDHT node" in _read_until(proc, "on port")[-1]
        proc.stdin.write("p tool-key hello from the repl\n")
        _read_until(proc, "put tool-key: ok")
        got = peer.get_future(jih.InfoHash.get("tool-key")).result(15)
        assert [v.data for v in got] == [b"hello from the repl"]
        proc.stdin.write("g tool-key\n")
        lines = _read_until(proc, "get tool-key: ok")
        assert any("value:" in x for x in lines)
        proc.stdin.write("ii idx alpha\n")
        _read_until(proc, "index insert alpha: ok")
        proc.stdin.write("il idx alpha\n")
        lines = _read_until(proc, "index lookup alpha: ok")
        assert any(f"entry: {jih.InfoHash.get('alpha')} 1" in x
                   for x in lines)
        for cmd in ("ll", "ls", "stats", "x"):
            proc.stdin.write(cmd + "\n")
        lines = _read_until(proc, "unknown command: x")
        text = "".join(lines)
        assert "1 good" in text and "messages (in/out)" in text
        assert "Search IPv4" in text
        proc.stdin.write("q\n")
        _read_until(proc, "Stopping node")
        assert proc.wait(timeout=15) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_dhtchat_and_dhtscanner_run(peer):
    chat = _tool("dhtchat", "-p", "0", "--bind", "127.0.0.1", "room1")
    try:
        assert "Joined room 'room1'" in _read_until(chat, "Joined room")[-1]
        chat.stdin.write("hi\n")
        chat.stdin.close()
        assert chat.wait(timeout=15) == 0
    finally:
        if chat.poll() is None:
            chat.kill()
            chat.wait()
    scan = _tool("dhtscanner", "-p", "0", "--bind", "127.0.0.1", "-b",
                 f"127.0.0.1:{peer.get_bound_port()}", "--wait", "1",
                 "--dump-metrics")
    try:
        out, _ = scan.communicate(timeout=30)
    finally:
        if scan.poll() is None:
            scan.kill()
            scan.wait()
    assert scan.returncode == 0, out
    assert "Scan complete: 1 nodes" in out
    assert str(peer.get_node_id()) in out
    assert "dht_scanner_nodes_discovered_total 1" in out


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(base, path, body=None):
    req = urllib.request.Request(base + path, data=body,
                                 method="POST" if body else "GET")
    try:
        with urllib.request.urlopen(req, timeout=15) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _gateway_answers(base, key):
    out = {"post": _http(base, f"/{key}", b"over http"),
           "get": _http(base, f"/{key}"),
           "missing": _http(base, "/"),
           "stats": _http(base, "/stats.json"),
           "metrics": _http(base, "/metrics")}
    code, ctype, body = out["get"]
    vals = json.loads(body)
    for v in vals:
        v.pop("id")                      # a random value id
    out["get"] = (code, ctype, vals)
    return out


def test_http_gateway_answers_as_jax(peer):
    """The port's gateway program and the JAX gateway over a JAX runner
    answer the same requests alike."""
    port = _free_port()
    proc = _tool("http_gateway", "-p", "0", "--bind", "127.0.0.1", "-b",
                 f"127.0.0.1:{peer.get_bound_port()}", "--http-port",
                 str(port))
    srv = None
    try:
        _read_until(proc, "HTTP gateway on")
        base = f"http://127.0.0.1:{port}"
        # the runner's ops wait for its bootstrap: poll the POST
        deadline = time.monotonic() + 15
        while True:
            code, _, body = _http(base, "/warm-up", b"x")
            if code == 200 or time.monotonic() > deadline:
                break
        assert code == 200, body
        port_ans = _gateway_answers(base, "gw-port")
        local = jdr.DhtRunner()
        local.run(port=0, bind4="127.0.0.1")
        local.bootstrap_nodes([(peer.get_node_id(), jsa.SockAddr(
            "127.0.0.1", peer.get_bound_port()))])
        srv = ThreadingHTTPServer(("127.0.0.1", 0), jgw.make_handler(local))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        jax_ans = _gateway_answers(
            f"http://127.0.0.1:{srv.server_address[1]}", "gw-jax")
        local.join()
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        proc.kill()
        proc.wait()
    for what in ("post", "get", "missing"):
        assert port_ans[what] == jax_ans[what], what
    assert port_ans["get"][2][0]["data"] == "b3ZlciBodHRw"   # "over http"
    for what in ("stats", "metrics"):
        assert port_ans[what][:2] == jax_ans[what][:2]
    stats = json.loads(port_ans["stats"][2])
    assert set(stats) == set(json.loads(jax_ans["stats"][2]))
    assert stats["ipv4"]["good_nodes"] == 1
    metrics = port_ans["metrics"][2].decode()
    assert 'dht_gateway_request_latency_seconds_count{op="put"}' in metrics
    assert 'dht_gateway_request_latency_seconds_count{op="get"} 1' in metrics
