"""One run of one cell: set-up, a measured window, the check, one line.

    python3 gpubench/run.py --workload g500-s12.p1 --seed 7 --seconds 10 --trace 0

Everything that belongs to one cell, configuration, traffic mix or
metric is a file found by its name in `BENCHMARK.json`:

    gpubench/workloads/<cell>.json     the cell's config, mix, trace plan
    gpubench/configs/<config>.json     the graph and the engine's settings
    gpubench/traffic/<mix>.json        the requests (`loadgen.py`)
    gpubench/reference/<pattern>.py    the plain count of one pattern
    gpubench/end_to_end/<metric>.py    `read(run)`: an end-to-end metric
    gpubench/metrics/<metric>.py       `read(run)`: a per-layer metric

The program under test is `repro_torch`'s request path: a `QueryEngine`
on the card over the graph the benchmark draws, every query an
`enqueue` followed by `run_pending` from a fresh plan cache (`Program`).
Set-up uploads the graph, builds the engine and runs one query of each
kind, which loads the kernels and fills the allocator's pools; the
window then counts the whole graph again and again in a closed loop,
each query as a pattern's first on the resident graph.  Once the window
has closed, the peak memory is read, the engine freed, and every count
of the run compared with the plain reference's, exactly.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import pathlib
import subprocess
import sys
import time
from dataclasses import dataclass, field

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(f"[gpubench] {msg}", file=sys.stderr, flush=True)


# --------------------------------------------------------------- catalog
class Catalog:
    """The benchmark's files under `root` (a checkout)."""

    def __init__(self, root: pathlib.Path = ROOT):
        self.root = pathlib.Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "gpubench"

    def _json(self, kind: str, name: str) -> dict:
        path = self.dir / kind / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file {path}")
        return json.loads(path.read_text())

    def cell(self, name: str) -> dict:
        """BENCHMARK.json's entry for the cell, with its own file's
        settings under "plan"."""
        entry = next((w for w in self.bench["workloads"]
                      if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        plan = self._json("workloads", name)
        for key in ("config", "traffic"):
            if plan[key] != entry[key]:
                raise ValueError(f"{name}: {key} {plan[key]!r} in its file, "
                                 f"{entry[key]!r} in BENCHMARK.json")
        return {**entry, "plan": plan}

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def mix(self, name: str) -> dict:
        return self._json("traffic", name)

    def readers(self, kind: str) -> list[tuple[dict, object]]:
        """(metric entry, reader module) for each metric of BENCHMARK.json's
        `kind` ("end_to_end" or "per_layer")."""
        sub = {"end_to_end": "end_to_end", "per_layer": "metrics"}[kind]
        out = []
        for m in self.bench[kind]:
            path = self.dir / sub / f"{m['name']}.py"
            spec = importlib.util.spec_from_file_location(
                f"gpubench_{sub}_{len(out)}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            out.append((m, mod))
        return out


# ------------------------------------------------------------------ run
@dataclass
class Done:
    """One completed (or failed) query."""

    pattern: str
    t0: float
    t1: float
    count: int | None
    dispatches: int
    failed: str = ""


@dataclass
class Run:
    """What a run measured; the metric readers read it."""

    setup_s: float = 0.0
    window_t0: float = 0.0
    window_t1: float = 0.0
    warm: list = field(default_factory=list)
    queries: list = field(default_factory=list)
    reading: object = None        # tracing.Reading of the stretches
    bounds: list | None = None    # K1 bounds of the stretches' calls

    @property
    def completed(self) -> list:
        return [q for q in self.queries if not q.failed]


def chips_ok(chips: int) -> bool:
    import torch

    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: no card, no run")
        return False
    if torch.cuda.device_count() < chips:
        log(f"the cell asks for {chips} cards, "
            f"{torch.cuda.device_count()} visible")
        return False
    return True


def executor_config(cfg: dict, graph):
    from repro_torch.core.executor import ExecutorConfig, auto_buckets

    if cfg["degree_buckets"] != "auto":
        raise ValueError(f"degree_buckets is 'auto', got "
                         f"{cfg['degree_buckets']!r}")
    return ExecutorConfig(capacity=int(cfg["capacity"]),
                          degree_buckets=auto_buckets(graph))


class Program:
    """The system under test as the window drives it: `repro_torch`'s
    `QueryEngine` on the card over the benchmark's graph, every query an
    `enqueue` followed by `run_pending`.

    Each query starts from a fresh plan cache, as a pattern's first
    query on a resident graph does: the configuration search, a matcher
    at the configured capacity warmed on a sentinel frontier, then the
    whole count with its splits and escalations.  A cached matcher keeps
    the capacity its last count escalated to, so a repeated query would
    skip that work.  The graph's upload and statistics are paid once,
    in set-up."""

    def __init__(self, g, config: dict, device):
        from repro_torch.graph.csr import GraphCSR
        from repro_torch.query import QueryEngine

        graph = GraphCSR(n=g.n, m=g.m, indptr=g.indptr.cpu().numpy(),
                         indices=g.indices.cpu().numpy(),
                         degrees=g.degrees.cpu().numpy(),
                         name=config["name"])
        self.engine = QueryEngine(
            graph, cfg=executor_config(config, graph),
            device=device)

    def describe(self) -> str:
        e = self.engine
        return (f"statistics {e.stats_seconds:.3f}s, triangles "
                f"{e.stats.tri_cnt}")

    def ask(self, kinds) -> tuple[list[tuple[int | None, str]], int]:
        """One request per kind in one round: ([(count, failure)], the
        round's dispatches)."""
        from repro_torch.core.pattern import Pattern
        from repro_torch.query import QueryRequest
        from repro_torch.query.cache import PlanCache

        e = self.engine
        e.cache = PlanCache(max_entries=e.cache.max_entries)
        tickets = [e.enqueue(QueryRequest(
            Pattern(k.vertices, k.edges, name=k.pattern), mode=k.mode,
            use_iep=k.use_iep)) for k in kinds]
        e.run_pending()
        out = []
        for t in tickets:
            res = t.result if t.done else None
            if res is None:
                out.append((None, "unresolved"))
            else:
                out.append((res.count,
                            "overflowed" if res.overflowed else ""))
        return out, e.last_round_dispatches


def measure(cat: Catalog, cell_name: str, seed: int, seconds: float,
            trace: bool, *, device: str, t_start: float,
            program=Program) -> dict:
    """Set up, run the window and check it; returns the result line.
    `program(graph, config, device)` is what the window drives: the
    port, or the control in its place (`control.py`)."""
    import torch

    from . import graphgen, loadgen, reference, tracing

    cell = cat.cell(cell_name)
    config = cat.config(cell["config"])
    mix = cat.mix(cell["traffic"])
    run = Run()
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dev = torch.device("cuda", 0) if cuda else torch.device(device)

    def ask(kinds, t0) -> list[Done]:
        answers, n = prog.ask(kinds)
        sync()
        t1 = time.perf_counter()
        return [Done(k.pattern, t0, t1, count, n / len(kinds), failed)
                for k, (count, failed) in zip(kinds, answers)]

    # ---- set-up: the graph, the program, one query of each kind
    from repro_torch.kernels import ops

    t = time.perf_counter()
    g = graphgen.draw_rmat(config, seed, dev)
    sync()
    log(f"graph {config['name']}: n={g.n} m={g.m} max_degree="
        f"{g.max_degree} drawn in {time.perf_counter() - t:.3f}s")
    t = time.perf_counter()
    prog = program(g, config, dev)
    sync()
    log(f"{program.__name__} built in {time.perf_counter() - t:.3f}s "
        f"({prog.describe()})")
    gen = loadgen.Requests(mix, seed)
    refs = {}
    for k in gen.kinds:
        refs[k.pattern] = mod = reference.load(k.pattern)
        if not reference.same_pattern(k.vertices, k.edges, mod.EDGES):
            raise ValueError(f"mix {cell['traffic']}: {k.pattern}'s edges "
                             f"are not reference/{k.pattern}.py's pattern")
    run.warm = ask(gen.kinds, time.perf_counter())
    for q in run.warm:
        log(f"warm-up {q.pattern}: count={q.count} dispatches="
            f"{q.dispatches:g} in {q.t1 - q.t0:.3f}s")
    mirror = None
    if trace:
        tp = cell["plan"]["trace"]
        tracing.warm_profiler(dev)
        S = int(tp["stretches"])
        mirror = tracing.make_mirror([seconds * i / S for i in range(S)],
                                     int(tp["dispatches"]))
    sync()
    run.setup_s = time.perf_counter() - t_start
    log(f"set-up {run.setup_s:.3f}s")

    # ---- the window: closed loop, until the last query started before
    # the deadline has completed
    with contextlib.ExitStack() as stack:
        if trace:
            stack.enter_context(tracing.K1Entries(ops))
            stack.enter_context(tracing.installed(mirror))
        run.window_t0 = t0 = time.perf_counter()
        deadline = t0 + seconds
        if trace:
            mirror.begin(t0)
        while t0 < deadline:
            kinds = gen.round()
            try:
                done = ask(kinds, t0)
            except Exception as e:     # the query is failed; stop the loop
                t1 = time.perf_counter()
                run.queries += [Done(k.pattern, t0, t1, None, 0, repr(e))
                                for k in kinds]
                log(f"query raised: {e!r}")
                break
            run.queries += done
            t1 = done[-1].t1
            log(f"round {len(run.queries) // len(kinds)}: {t1 - t0:.4f}s, "
                f"{sum(q.dispatches for q in done):g} dispatches")
            t0 = t1
        run.window_t1 = t0
    log(f"window {run.window_t1 - run.window_t0:.3f}s: "
        f"{len(run.completed)} of {len(run.queries)} queries completed")
    peak = (max(torch.cuda.max_memory_allocated(d)
                for d in range(cell["chips"])) if cuda else 0)

    # ---- the traced run's reading: stretches, then K1's bounds
    if trace:
        t = time.perf_counter()
        engine = prog.engine
        run.bounds = tracing.replay_bounds(engine, mirror.stretches,
                                           engine.cfg.capacity, sync)
        run.reading = tracing.reduce(
            [tracing.events_of(s.prof) for s in mirror.stretches])
        log(f"{len(mirror.stretches)} stretches of "
            f"{[len(s.dispatches) for s in mirror.stretches]} dispatches, "
            f"{[round(s.wall_s, 3) for s in mirror.stretches]} s; read "
            f"in {time.perf_counter() - t:.3f}s")
        del mirror, engine

    # ---- the check: free the program, count with the reference
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    want = {}
    for name, mod in refs.items():
        t = time.perf_counter()
        want[name] = mod.count(g)
        sync()
        log(f"reference {name}: {want[name]} in "
            f"{time.perf_counter() - t:.3f}s")
    answers = run.warm + run.queries
    gaps = [abs(q.count - want[q.pattern]) for q in answers
            if q.count is not None]
    failed = sum(1 for q in run.queries if q.failed)
    checks = {"count_gap": {"value": max(gaps, default=0), "limit": 0},
              "failed_queries": {"value": failed + sum(
                  1 for q in run.warm if q.failed), "limit": 0}}
    correct = (bool(run.completed) and bool(gaps)
               and all(c["value"] <= c["limit"] for c in checks.values()))

    # ---- the line
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m, mod in cat.readers(kind):
        value = mod.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else device,
                   "kind": torch.cuda.get_device_name(0) if cuda else device,
                   "count": cell["chips"], "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": len(run.queries),
            "failed": failed, "metrics": metrics, "device": device_info}
    if trace and run.reading is not None:
        r = run.reading
        device_info["busy_s"] = r.busy_ns / 1e9
        device_info["window_s"] = r.window_ns / 1e9
        line["breakdown"] = {"device_ops": tracing.top(r.ops),
                             "idle_gaps": tracing.top(r.gaps)}
    line["checks"] = checks
    if cuda:
        log(f"card: {card_report()}")
    return line


def card_report() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules
                  if m.split(".", 1)[0] in FORBIDDEN)


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="gpubench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, t_start: float | None = None, device: str = "cuda",
         root: pathlib.Path = ROOT) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    cat = Catalog(root)
    cell = cat.cell(args.workload)
    if device == "cuda" and not chips_ok(cell["chips"]):
        return 3
    line = measure(cat, args.workload, args.seed, args.seconds,
                       bool(args.trace), device=device, t_start=t_start)
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 4
    for name, c in line["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(line), flush=True)
    return 0
