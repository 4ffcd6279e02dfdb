"""The reference's sharded counts, for `tests/test_torch_sharded.py`.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
        PYTHONPATH=src python tests/ref_sharded.py CASES.json OUT.json

Runs in a process of its own, because JAX fixes its device count at
start-up: `repro.core.executor.ShardedMatcher` over a mesh of the first
W of 4 host devices, for each case of CASES.json (a list of
[id, dataset, pattern, labels, mode, use_iep, capacity, worlds]).
Writes, per case, the plan record and, per world size, the striped
roots `_v0`, the count, `max_needed`, the overflow flag and the sticky
capacity after the count.
"""
import json
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs.graphpi import get_pattern  # noqa: E402
from repro.core import executor as rx  # noqa: E402
from repro.core.config_search import (  # noqa: E402
    graphzero_configuration, search_configuration,
)
from repro.core.plan import build_plan, plan_to_dict  # noqa: E402
from repro.graph.datasets import named_dataset  # noqa: E402


def plan_of(pattern, stats, mode, use_iep):
    if mode == "graphzero":
        c = graphzero_configuration(pattern, stats, use_iep=use_iep)
    else:
        c = search_configuration(pattern, stats,
                                 use_iep=use_iep and mode != "naive").best
    return build_plan(pattern, c.order, () if mode == "naive" else c.res_set,
                      iep_k=c.iep_k)


def main(cases_path, out_path):
    assert jax.device_count() == 4, jax.devices()
    graphs, out = {}, {}
    for cid, gname, pname, labels, mode, iep, cap, worlds in json.load(
            open(cases_path)):
        if gname not in graphs:
            g = named_dataset(gname)
            graphs[gname] = (g, rx.compute_stats(
                g, rx.ExecutorConfig(capacity=4096)))
        g, stats = graphs[gname]
        pattern = get_pattern(pname)
        if labels is not None:
            pattern = pattern.with_labels(tuple(labels))
        plan = plan_of(pattern, stats, mode, iep)
        rec = {"plan": plan_to_dict(plan), "worlds": {}}
        for W in worlds:
            mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
            m = rx.ShardedMatcher(g, plan, mesh,
                                  cfg=rx.ExecutorConfig(capacity=cap))
            r = m.count()
            rec["worlds"][str(W)] = {
                "v0": np.asarray(m._v0).tolist(), "count": r.count,
                "max_needed": r.max_needed, "overflowed": r.overflowed,
                "capacity": m._capacity}
        out[cid] = rec
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
