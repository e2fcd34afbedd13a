"""The port's cluster harness against the JAX package's: the scenarios
of ``harness.scenarios`` at small sizes give equal dicts in both
packages (apart from their wall-clock rates), the benchmark CLI's
``--swarm`` on the CPU prints JAX's keys with every lookup done, and
``tests/test_conformance.py``'s ``host_lookup_stats`` on 64 nodes gives
the same recalls and rounds through either package's cluster."""

import json
import os
import random

import numpy as np
import pytest
import torch

import opendht_tpu.harness.network as jnet
import opendht_tpu.harness.scenarios as jsc
import opendht_tpu_torch.harness.benchmark as tbench
import opendht_tpu_torch.harness.network as tnet
import opendht_tpu_torch.harness.scenarios as tsc
import opendht_tpu_torch.utils.infohash as tih

import test_conformance as conf

# Wall-clock rates: the only keys that may differ between the runs.
WALL_KEYS = {"puts_per_sec", "local_gets_per_sec", "wall_s"}

SMALL = {
    "gets": dict(n_nodes=12, rounds=2, gets_per_round=6),
    "delete": dict(n_nodes=12, n_values=3),
    "replace": dict(n_nodes=12),
    "listen": dict(n_nodes=8),
    "local": dict(n_keys=64),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded(monkeypatch, seed=77):
    stream = random.Random(seed)
    monkeypatch.setattr(os, "urandom", lambda n: stream.randbytes(n))
    random.seed(seed)


def test_scenario_table_equal():
    assert sorted(jsc.SCENARIOS) == sorted(tsc.SCENARIOS) == sorted(SMALL)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_scenarios_equal(name, monkeypatch):
    out = {}
    for pkg, sc in (("jax", jsc), ("port", tsc)):
        _seeded(monkeypatch)
        res = sc.SCENARIOS[name](**SMALL[name])
        out[pkg] = {k: v for k, v in res.items() if k not in WALL_KEYS}
    assert out["jax"] == out["port"]
    assert out["port"]


def test_benchmark_cli_scenario(capsys, monkeypatch):
    _seeded(monkeypatch)
    assert tbench.main(["-t", "listen", "-n", "8"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["scenario"] == "listen" and "wall_s" in out
    assert out["sent"] == 5


def test_benchmark_swarm_cpu(capsys):
    """``--swarm`` at 4,096 nodes on the CPU: JAX's keys, every lookup
    done."""
    assert tbench.main(["--swarm", "-n", "4096", "-l", "256",
                        "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"scenario", "n_nodes", "n_lookups",
                        "lookups_per_sec", "median_hops", "done_frac"}
    assert out["scenario"] == "swarm" and out["n_nodes"] == 4096
    assert out["n_lookups"] == 256 and out["done_frac"] == 1.0
    assert 1.0 <= out["median_hops"] <= 12.0


def test_host_lookup_stats_equal(monkeypatch):
    """``host_lookup_stats`` of the conformance test, 50 lookups on a
    64-node cluster of each package (its ``InfoHash`` the package's)."""
    monkeypatch.setattr(conf, "N_LOOKUPS", 50)
    out = {}
    for pkg, net, ih in (("jax", jnet, conf.InfoHash),
                         ("port", tnet, tih.InfoHash)):
        _seeded(monkeypatch)
        monkeypatch.setattr(conf, "InfoHash", ih)
        c = net.DhtNetwork(64, seed=7)
        c.interconnect()
        c.run(30.0)
        out[pkg] = conf.host_lookup_stats(c)
    (jr, jrounds), (tr, trounds) = out["jax"], out["port"]
    assert np.array_equal(jr, tr) and np.array_equal(jrounds, trounds)
    assert jr.mean() > 0.9 and 1.0 <= trounds.mean() <= 12
