"""Benchmark CLI over the scenario suite + the device swarm engine.

Parity with the reference's ``python/tools/benchmark.py`` (WorkBench
:37-143, CLI :145-240):

    python -m opendht_tpu_torch.harness.benchmark --performance -t gets
    python -m opendht_tpu_torch.harness.benchmark --persistence -t delete
    python -m opendht_tpu_torch.harness.benchmark --swarm -n 100000 -l 10000

The ``--swarm`` mode runs the device-resident lock-step engine
(:mod:`opendht_tpu_torch.models.swarm`, on the card unless ``--device
cpu``) instead of the event-driven cluster — the configuration the
reference could never reach.  It prints the JAX package's keys.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .scenarios import SCENARIOS


def run_scenario(name: str, args) -> dict:
    fn = SCENARIOS[name]
    t0 = time.monotonic()
    kw = {}
    if args.node_num is not None:
        kw["n_nodes"] = args.node_num
    if args.seed is not None:
        kw["seed"] = args.seed
    out = fn(**kw)
    out["scenario"] = name
    out["wall_s"] = round(time.monotonic() - t0, 2)
    return out


def run_swarm(args, device=None) -> dict:
    """``--swarm``: the device swarm's batched lookups (K1 under
    ``merge_impl="auto"``) on the card unless ``device`` (or
    ``--device``) says otherwise; one warm-up batch, then one timed."""
    import numpy as np
    import torch
    from ..models.swarm import (SwarmConfig, build_swarm, lookup,
                                resolve_device)

    dev = resolve_device(device if device is not None
                         else getattr(args, "device", None))

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cfg = SwarmConfig.for_nodes(args.node_num
                                if args.node_num is not None else 100_000,
                                device=dev)
    swarm = build_swarm(cfg, gen(args.seed if args.seed is not None else 0),
                        device=dev)
    targets = torch.randint(0, 2**32, (args.lookups, 5), generator=gen(1),
                            dtype=torch.int64, device=dev)
    lookup(swarm, cfg, targets, gen(2), device=dev)
    sync()
    t0 = time.monotonic()
    res = lookup(swarm, cfg, targets, gen(3), device=dev)
    sync()
    dt = time.monotonic() - t0
    return {
        "scenario": "swarm",
        "n_nodes": cfg.n_nodes,
        "n_lookups": args.lookups,
        "lookups_per_sec": round(args.lookups / dt, 1),
        "median_hops": float(np.median(res.hops.cpu().numpy())),
        "done_frac": float(res.done.float().mean()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark", description=__doc__)
    ap.add_argument("--performance", action="store_true")
    ap.add_argument("--persistence", action="store_true")
    ap.add_argument("--swarm", action="store_true")
    ap.add_argument("-t", "--test", default="gets",
                    choices=sorted(SCENARIOS))
    ap.add_argument("-n", "--node-num", type=int, default=None)
    ap.add_argument("-l", "--lookups", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="--swarm's device (default: the card)")
    args = ap.parse_args(argv)

    if args.swarm:
        out = run_swarm(args)
    else:
        out = run_scenario(args.test, args)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
