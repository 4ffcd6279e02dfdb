"""Front door: `python -m repro_torch.analysis` — run the static
verifier over the port.

Port of `repro/analysis/__main__.py`.  Default runs all three passes
over the checkout and the P1–P6 pattern library; exit status is 1 iff
any ERROR finding is produced.

  python -m repro_torch.analysis                      # lint + kernel + soundness
  python -m repro_torch.analysis --lint               # one pass only
  python -m repro_torch.analysis --soundness
  python -m repro_torch.analysis --kernel-contracts --deep
  python -m repro_torch.analysis --kernel-contracts --deep \\
      --dataset wiki-vote-syn --model-buckets
  python -m repro_torch.analysis --fsck /path/to/plan-store
  python -m repro_torch.analysis --root /some/checkout --lint
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .findings import Finding, error_count, format_findings
from .kernel_contracts import check_graph_contract
from .lint import lint_tree
from .soundness import verify_plan, verify_restriction_set

# shape-only contract probes at paper scale (n, m, max_degree) — graphs
# the tests cannot materialize but production serves (Table I ballpark)
_PAPER_SHAPES = (
    ("wiki-vote", (7_115, 103_689, 1_065)),
    ("patents", (3_774_768, 16_518_948, 793)),
    ("orkut", (3_072_441, 117_185_083, 33_313)),
)


def run_lint(root: Path) -> list[Finding]:
    return lint_tree(root)


def run_soundness() -> list[Finding]:
    """Prove every restriction set the planner can generate for the
    benchmark patterns, then one end-to-end plan per pattern."""
    from ..configs.graphpi import EXTRA_PATTERNS, PATTERNS
    from ..core.plan import best_iep_k, build_plan
    from ..core.restrictions import generate_restriction_sets
    from ..core.schedule import generate_schedules

    out: list[Finding] = []
    for name, pat in {**PATTERNS, **EXTRA_PATTERNS}.items():
        for rs in generate_restriction_sets(pat):
            out += verify_restriction_set(
                pat, rs, location=f"{name} res_set={tuple(rs)}")
        rs = generate_restriction_sets(pat)[0]
        order = next(iter(generate_schedules(pat)))
        k = best_iep_k(pat, order, rs)
        plan = build_plan(pat, order, rs, iep_k=k)
        out += verify_plan(plan, location=f"{name} plan iep_k={k}")
    return out


def run_kernel_contracts(*, deep: bool, datasets=("tiny-er",),
                         model_buckets: bool = False) -> list[Finding]:
    """The deep pass over each named dataset (with the degree buckets
    the perf model sizes, `--model-buckets`, as the launchers do), then
    the paper's shapes by arithmetic alone."""
    out: list[Finding] = []
    if deep:
        from dataclasses import replace

        from ..core.executor import ExecutorConfig, auto_buckets
        from ..graph.datasets import named_dataset

        for name in datasets:
            graph = named_dataset(name)
            cfg = ExecutorConfig()
            if model_buckets:
                cfg = replace(cfg, degree_buckets=auto_buckets(graph))
            out += check_graph_contract(graph, cfg, deep=True)
    for label, shape in _PAPER_SHAPES:
        for f in check_graph_contract(shape):
            out.append(Finding(f.severity, f.rule,
                               f"{label}/{f.location}", f.message))
    return out


def run_fsck(store_dir: Path) -> list[Finding]:
    from ..query.store import PlanStore

    store = PlanStore(store_dir)
    report = store.fsck()
    out: list[Finding] = []
    for digest, findings in report["findings"].items():
        out += findings
    sys.stdout.write(
        f"fsck: {report['checked']} records checked, "
        f"{report['quarantined']} quarantined, "
        f"{report['stats_checked']} stats records checked, "
        f"{report['overlays_checked']} overlay records checked\n")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static soundness verifier")
    ap.add_argument("--root", type=Path, default=Path.cwd(),
                    help="repo checkout to lint (default: cwd)")
    ap.add_argument("--lint", action="store_true",
                    help="repo-invariant AST lint only")
    ap.add_argument("--soundness", action="store_true",
                    help="plan/restriction soundness over P1-P6 only")
    ap.add_argument("--kernel-contracts", action="store_true",
                    help="kernel contract proofs only")
    ap.add_argument("--deep", action="store_true",
                    help="also run each K1 entry's input checks on meta "
                         "tensors of every call shape of --dataset")
    ap.add_argument("--dataset", action="append", default=None,
                    help="graph the deep pass reads (repeatable; default "
                         "tiny-er)")
    ap.add_argument("--model-buckets", action="store_true",
                    help="deep pass over the auto-sized degree buckets")
    ap.add_argument("--fsck", type=Path, metavar="DIR",
                    help="run PlanStore.fsck() on this store directory")
    args = ap.parse_args(argv)

    selected = args.lint or args.soundness or args.kernel_contracts \
        or args.fsck is not None
    findings: list[Finding] = []
    if args.lint or not selected:
        findings += run_lint(args.root)
    if args.kernel_contracts or not selected:
        findings += run_kernel_contracts(
            deep=args.deep, datasets=tuple(args.dataset or ("tiny-er",)),
            model_buckets=args.model_buckets)
    if args.soundness or not selected:
        findings += run_soundness()
    if args.fsck is not None:
        findings += run_fsck(args.fsck)

    errs = error_count(findings)
    print(format_findings(
        findings,
        header=f"repro_torch.analysis: {len(findings)} finding(s), "
               f"{errs} error(s)"))
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
