"""PlanStore — the persistent half of the plan cache.

Port of `repro/query/store.py`.  The in-memory `PlanCache` pays the
GraphPi configuration search once per process and loses it on restart.
Cache keys are process-stable (canonical pattern sha256 + content
fingerprints — nothing keyed on `id()` or Python hashing), so
persistence is purely additive: this module maps each key to an on-disk
record holding

  * the searched `Configuration` (core/config_search.py dict round-trip),
  * the built `MatchingPlan` (core/plan.py dict round-trip).

The reference also stores an AOT-compiled executable beside each record
(`<digest>.exec`).  The port's matcher runs eager PyTorch around
kernels built once per process from the checkout's sources, so there is
nothing to serialize: the port never writes `.exec` files, every record
says ``"has_executable": false``, and such a record is valid in either
package's reader.  A restarted replica still skips the search; it warms
its matchers afresh (`CacheStats.n_compiles`).

Layout under the cache dir (one schema version = one directory, so a
format change never aliases old records):

    <root>/v2/<key-digest>.json           header + config + plan records
    <root>/v2/stats-<graph fp>.json       graph statistics
    <root>/v2/live-<base fp>.json         a live graph's overlay

Schema v2 (this version) carries vertex labels: the pattern record may
hold a "labels" list and the plan record a "vlabels" list (both omitted
for unlabeled patterns, whose encoding is byte-identical to v1).  The
v1 directory is still READ for unlabeled patterns, but a v1 record
claiming label fields is rejected (`v1-labeled`): v1 writers could not
have produced it, so it can only be tampering or corruption.  All writes
target the v2 directory.

`<key-digest>` is sha256 over the canonical JSON of the full PlanCache
entry key — (canonical pattern key, graph fingerprint, executor
fingerprint string, mode, use_iep, layout fingerprint) — so anything
that would change the searched configuration or the count program lands
at a different path by construction.

Invalidation headers.  Every record carries (schema_version, torch,
cuda, repro_torch_fingerprint) where the reference writes (jax, jaxlib,
repro_fingerprint, backend).  A version or code-fingerprint mismatch
REJECTS the whole record: plans built by different plan-time code may be
stale in ways no structural check catches.  So a store written by one
package is rejected (counted) by the other's reader, never misread.  The
config, plan, stats and overlay record bodies are field-equal to the
reference's for the same plan.  All rejections are counted, never
raised: a corrupt or stale store must degrade to cold-start, not take
down serving.

Writes are atomic (tmp file + `os.replace`) so a crashed writer or two
racing replicas warming the same dir never leave torn records.
"""
from __future__ import annotations

import functools
import hashlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Iterator

import torch

from ..core.config_search import (
    Configuration, config_from_dict, config_to_dict,
)
from ..core.pattern import Pattern
from ..core.plan import MatchingPlan, plan_from_dict, plan_to_dict
from ..obs import get_tracer

SCHEMA_VERSION = 2
# Older schema directories the loader still reads (unlabeled records
# only); writes always target the current version.
LEGACY_SCHEMA_VERSIONS = (1,)

# Modules whose source shapes plan records or count programs — the
# full plan-time pipeline (pattern/labels, schedule/restriction
# generation, perf-model ranking, configuration search) plus the
# port's executor and kernel wrappers (the reference's list,
# `repro/query/store.py:81-93`, over the port's modules): a drift in any
# of them invalidates every persisted entry (cheap and sound — false
# invalidation just costs one cold start per entry).
_FINGERPRINTED_MODULES = (
    "repro_torch.core.config_search",
    "repro_torch.core.executor",
    "repro_torch.core.iep",
    "repro_torch.core.pattern",
    "repro_torch.core.perf_model",
    "repro_torch.core.plan",
    "repro_torch.core.restrictions",
    "repro_torch.core.schedule",
    "repro_torch.kernels.ops",
    "repro_torch.kernels.intersect",
    "repro_torch.query.canon",
)


@functools.lru_cache(maxsize=1)
def repro_torch_fingerprint() -> str:
    """sha256 over the source bytes of the plan/executor-shaping modules."""
    import importlib

    h = hashlib.sha256()
    for name in _FINGERPRINTED_MODULES:
        mod = importlib.import_module(name)
        with open(mod.__file__, "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    return h.hexdigest()


def _jsonify(obj):
    """Canonical JSON-compatible form of a (nested-tuple) cache key."""
    if isinstance(obj, (tuple, list)):
        return [_jsonify(x) for x in obj]
    return obj


def key_digest(key: tuple) -> str:
    """Stable digest of a PlanCache entry key (any nesting of primitives)."""
    payload = json.dumps(_jsonify(key), separators=(",", ":"),
                         sort_keys=False)
    return hashlib.sha256(payload.encode()).hexdigest()


@dataclass
class StoreStats:
    loads: int = 0               # records successfully loaded
    misses: int = 0              # key not present
    saves: int = 0
    exec_drops: int = 0          # the reference's key; always 0 here
    save_fails: int = 0
    verify_fails: int = 0        # records rejected by the soundness pass
    rejects: dict = field(default_factory=dict)   # reason -> count

    def reject(self, reason: str) -> None:
        self.rejects[reason] = self.rejects.get(reason, 0) + 1

    def as_dict(self) -> dict:
        return dict(self.__dict__, rejects=dict(self.rejects))


@dataclass
class StoreRecord:
    """One rehydrated entry: everything the cache needs except a matcher."""

    digest: str
    pattern: Pattern             # canonical labeling (as searched)
    config: Configuration
    plan: MatchingPlan
    mode: str
    use_iep: bool
    sharded: bool
    header: dict                 # raw record header (reporting/debugging)

    @property
    def search_seconds(self) -> float:
        return float(self.header.get("search_seconds", 0.0))


class PlanStore:
    """Versioned on-disk index of searched configurations and plans."""

    def __init__(self, root: str):
        self.root = root
        self.vdir = os.path.join(root, f"v{SCHEMA_VERSION}")
        os.makedirs(self.vdir, exist_ok=True)
        self.stats = StoreStats()

    def _version_dirs(self) -> list[tuple[int, str]]:
        """(schema_version, dir) pairs the loader consults, current first.
        Legacy dirs are only listed when they exist on disk."""
        out = [(SCHEMA_VERSION, self.vdir)]
        for v in LEGACY_SCHEMA_VERSIONS:
            d = os.path.join(self.root, f"v{v}")
            if os.path.isdir(d):
                out.append((v, d))
        return out

    # Non-plan record filename prefixes sharing the version dirs:
    # graph-stats records and live-overlay records (both keyed on graph
    # content, not plan keys).
    _AUX_PREFIXES = ("stats-", "live-")

    def __len__(self) -> int:
        return sum(
            1
            for _, d in self._version_dirs()
            for f in os.listdir(d)
            if f.endswith(".json")
            and not f.startswith(self._AUX_PREFIXES)
        )

    # ------------------------------------------------------------ paths
    def _path(self, digest: str, vdir: str | None = None) -> str:
        return os.path.join(vdir or self.vdir, digest + ".json")

    def header(self) -> dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "repro_torch_fingerprint": repro_torch_fingerprint(),
        }

    def _check_header(self, rec: dict,
                      expect_version: int = SCHEMA_VERSION) -> str | None:
        """None when the record is usable, else the rejection reason."""
        if rec.get("schema_version") != expect_version:
            return "schema_version"
        if rec.get("torch") != torch.__version__ or \
                rec.get("cuda") != torch.version.cuda:
            return "torch_version"
        if rec.get("repro_torch_fingerprint") != repro_torch_fingerprint():
            return "repro_torch_fingerprint"
        return None

    @staticmethod
    def _record_labeled(rec: dict) -> bool:
        """Does the raw record claim any v2 label field?"""
        return (
            rec.get("pattern", {}).get("labels") is not None
            or rec.get("plan", {}).get("vlabels") is not None
            or rec.get("plan", {}).get("pattern", {}).get("labels")
            is not None
        )

    @staticmethod
    def _key_mismatch(rec: dict, *patterns: Pattern) -> bool:
        """True when any given pattern's canonical key disagrees with the
        record's own stored key — i.e. the record sits in a slot that a
        different (label-)isomorphism class owns.  `canonical_key` folds
        labels into the digest, so swapping two labels in a persisted
        pattern/plan moves its key even when the automorphism structure
        and every internal invariant are untouched."""
        from .canon import canonical_key

        key = rec.get("key")
        if not isinstance(key, list) or not key or \
                not isinstance(key[0], str):
            return True
        try:
            return any(canonical_key(p) != key[0] for p in patterns)
        except ValueError:          # uncanonicalizable pattern
            return True

    # ------------------------------------------------------------- save
    def save(self, key: tuple, *, pattern: Pattern, config: Configuration,
             plan: MatchingPlan, search_seconds: float = 0.0,
             compile_seconds: float = 0.0,
             schema_version: int = SCHEMA_VERSION) -> str | None:
        """Write-behind one entry; returns the digest, or None when the
        write failed (serving never crashes on a read-only/full disk).

        `schema_version` is a migration/test seam: passing a legacy
        version writes the record into that version's directory with the
        matching header.  Labeled patterns refuse to downgrade — v1 has
        no label fields, so a "v1 labeled record" would be exactly the
        corruption the loader's `v1-labeled` check exists to catch."""
        if schema_version != SCHEMA_VERSION:
            if schema_version not in LEGACY_SCHEMA_VERSIONS:
                raise ValueError(f"unknown schema version {schema_version}")
            if pattern.labels is not None or plan.vlabels is not None:
                raise ValueError(
                    "labeled patterns cannot be written as schema "
                    f"v{schema_version} (labels are a v2 field)")
        vdir = os.path.join(self.root, f"v{schema_version}")
        os.makedirs(vdir, exist_ok=True)
        digest = key_digest(key)
        json_path = self._path(digest, vdir)
        record = {
            **self.header(),
            "schema_version": schema_version,
            "key": _jsonify(key),
            "mode": key[3],
            "use_iep": bool(key[4]),
            "sharded": bool(key[5] and key[5][0] == "sharded"),
            "created_at": time.time(),
            "search_seconds": float(search_seconds),
            "compile_seconds": float(compile_seconds),
            "pattern": pattern.to_dict(),
            "config": config_to_dict(config),
            "plan": plan_to_dict(plan),
            "has_executable": False,
        }
        with get_tracer().span("store.save", digest=digest[:12]):
            try:
                self._atomic_write(
                    json_path,
                    json.dumps(record, separators=(",", ":")).encode())
            except OSError:
                self.stats.save_fails += 1
                return None
        self.stats.saves += 1
        return digest

    def _atomic_write(self, path: str, data: bytes) -> None:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # ------------------------------------------------------------- load
    def load(self, key: tuple) -> StoreRecord | None:
        """Load-through for one key; None = absent or rejected (counted).

        Consults the current schema directory first, then any legacy
        directories (unlabeled records only — cache keys are stable
        across the v1→v2 bump for unlabeled patterns, so a v2 store
        opened over a v1 tree warm-loads the old records in place)."""
        return self._load_digest(key_digest(key))

    def _load_digest(self, digest: str) -> StoreRecord | None:
        with get_tracer().span("store.load", digest=digest[:12]) as sp:
            dirs = self._version_dirs()
            for version, vdir in dirs:
                if os.path.exists(self._path(digest, vdir)):
                    return self._load_checked(digest, sp, version=version,
                                              vdir=vdir)
            self.stats.misses += 1
            sp.set(outcome="miss")
            return None

    def _load_checked(self, digest: str, sp, *,
                      version: int = SCHEMA_VERSION,
                      vdir: str | None = None) -> StoreRecord | None:
        json_path = self._path(digest, vdir)
        if not os.path.exists(json_path):
            self.stats.misses += 1
            sp.set(outcome="miss")
            return None
        try:
            with open(json_path) as f:
                rec = json.load(f)
        except (OSError, json.JSONDecodeError):
            self.stats.reject("corrupt")
            sp.set(outcome="corrupt")
            return None
        reason = self._check_header(rec, expect_version=version)
        if reason is not None:
            self.stats.reject(reason)
            sp.set(outcome=f"stale:{reason}")
            return None
        if version != SCHEMA_VERSION and self._record_labeled(rec):
            # labels are a v2 field; a v1 record claiming them was not
            # written by any v1 writer — tampering or corruption
            self.stats.reject("v1-labeled")
            sp.set(outcome="v1-labeled")
            return None
        try:
            pattern = Pattern.from_dict(rec["pattern"])
            config = config_from_dict(rec["config"])
            plan = plan_from_dict(rec["plan"])
        except (KeyError, TypeError, ValueError):
            self.stats.reject("corrupt")
            sp.set(outcome="corrupt")
            return None
        # The digest is derived from the CANONICAL pattern key, and the
        # record stores the canonically-relabeled pattern — so a record
        # whose pattern (edges OR labels) disagrees with its own key
        # serves some other query's slot.  Both the top-level pattern and
        # the plan's embedded copy are checked: flipped-label tampering
        # always lands here even when the flipped plan is internally
        # sound (verify_plan only proves internal consistency).
        if self._key_mismatch(rec, pattern, plan.pattern):
            self.stats.reject("key-pattern-mismatch")
            sp.set(outcome="key-pattern-mismatch")
            return None
        # plan_from_dict round-trips blindly by design (O(read) loads);
        # re-prove soundness here so a drifted/tampered record degrades
        # to a miss instead of serving a wrong count.
        mode = str(rec.get("mode", "graphpi"))
        from ..analysis.findings import has_errors
        from ..analysis.soundness import verify_plan

        with get_tracer().span("store.verify", digest=digest[:12]):
            bad = has_errors(verify_plan(plan, mode=mode, location=digest))
        if bad:
            self.stats.verify_fails += 1
            self.stats.reject("verify")
            sp.set(outcome="verify_fail")
            return None
        self.stats.loads += 1
        sp.set(outcome="load")
        return StoreRecord(
            digest=digest,
            pattern=pattern,
            config=config,
            plan=plan,
            mode=mode,
            use_iep=bool(rec.get("use_iep", False)),
            sharded=bool(rec.get("sharded", False)),
            header={k: rec[k] for k in rec
                    if k not in ("pattern", "config", "plan")},
        )

    def records(self) -> Iterator[StoreRecord]:
        """Every loadable record (rejections counted, not raised) — the
        warm-from-disk path iterates these and keeps the compatible ones.
        Spans all version directories; when the same digest exists in
        several, the newest schema's copy shadows the legacy one (exactly
        what `load` would serve)."""
        seen: set[str] = set()
        for _, vdir in self._version_dirs():
            for fname in sorted(os.listdir(vdir)):
                if not fname.endswith(".json") or \
                        fname.startswith(self._AUX_PREFIXES):
                    continue
                digest = fname[: -len(".json")]
                if digest in seen:
                    continue
                seen.add(digest)
                rec = self._load_digest(digest)
                if rec is not None:
                    yield rec

    # ------------------------------------------------------- graph stats
    # GraphStats (|V|, |E|, exact triangle count) is a property of the
    # DATA GRAPH, not of plan-time code, so its record is keyed purely by
    # the graph's content fingerprint and survives code/torch upgrades that
    # invalidate plan records; only a schema change rejects it.
    def _stats_path(self, graph_fingerprint: str) -> str:
        return os.path.join(self.vdir, f"stats-{graph_fingerprint}.json")

    def save_graph_stats(self, graph_fingerprint: str, stats) -> bool:
        """Persist |V|/|E|/tri_cnt for one graph; False on write failure
        (same degradation policy as plan saves)."""
        record = {
            "schema_version": SCHEMA_VERSION,
            "created_at": time.time(),
            "graph_fingerprint": graph_fingerprint,
            "n_vertices": int(stats.n_vertices),
            "n_edges": int(stats.n_edges),
            "tri_cnt": int(stats.tri_cnt),
        }
        try:
            self._atomic_write(
                self._stats_path(graph_fingerprint),
                json.dumps(record, separators=(",", ":")).encode())
        except OSError:
            self.stats.save_fails += 1
            return False
        self.stats.saves += 1
        return True

    def load_graph_stats(self, graph_fingerprint: str):
        """Rehydrated `GraphStats` for this graph, or None (counted)."""
        from ..core.perf_model import GraphStats

        path = self._stats_path(graph_fingerprint)
        if not os.path.exists(path):
            self.stats.misses += 1
            return None
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, json.JSONDecodeError):
            self.stats.reject("stats_corrupt")
            return None
        if rec.get("schema_version") != SCHEMA_VERSION or \
                rec.get("graph_fingerprint") != graph_fingerprint:
            self.stats.reject("stats_mismatch")
            return None
        try:
            stats = GraphStats(n_vertices=int(rec["n_vertices"]),
                               n_edges=int(rec["n_edges"]),
                               tri_cnt=int(rec["tri_cnt"]))
        except (KeyError, TypeError, ValueError):
            self.stats.reject("stats_corrupt")
            return None
        if stats.n_vertices < 0 or stats.n_edges < 0 or stats.tri_cnt < 0:
            self.stats.reject("stats_corrupt")
            return None
        self.stats.loads += 1
        return stats

    # ---------------------------------------------------- overlay records
    # A live engine's delta overlay (live/overlay.py) is graph state, not
    # plan state: the record is keyed by the ORIGINAL base graph's content
    # fingerprint and holds the cumulative insert/delete sets vs that
    # base, so a restarted replica can replay the mutations and resume at
    # the same edge epoch.  Like stats records it survives code upgrades;
    # only a schema change or structural damage rejects it.
    def _overlay_path(self, base_fingerprint: str) -> str:
        return os.path.join(self.vdir, f"live-{base_fingerprint}.json")

    @staticmethod
    def _check_overlay(rec: dict, base_fingerprint: str | None = None
                       ) -> str | None:
        """None when structurally valid, else the rejection reason.
        Validates exactly what `DeltaOverlay.from_record` will trust:
        normalized (u < v, non-negative int) edge pairs, disjoint
        insert/delete sets, non-negative epoch counters."""
        if rec.get("schema_version") != SCHEMA_VERSION:
            return "overlay_schema"
        fp = rec.get("base_fingerprint")
        if not isinstance(fp, str) or not fp:
            return "overlay_fingerprint"
        if base_fingerprint is not None and fp != base_fingerprint:
            return "overlay_fingerprint"
        for key in ("edge_epoch", "stats_epoch", "compactions"):
            v = rec.get(key)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                return "overlay_epoch"
        sets = {}
        for key in ("inserts", "deletes"):
            edges = rec.get(key)
            if not isinstance(edges, list):
                return "overlay_edges"
            seen = set()
            for e in edges:
                if (not isinstance(e, list) or len(e) != 2
                        or not all(isinstance(x, int)
                                   and not isinstance(x, bool)
                                   for x in e)
                        or not 0 <= e[0] < e[1]):
                    return "overlay_edges"
                seen.add((e[0], e[1]))
            sets[key] = seen
        if sets["inserts"] & sets["deletes"]:
            return "overlay_edges"
        return None

    def save_overlay(self, record: dict) -> bool:
        """Write-behind one live-overlay record (the engine calls this at
        every mutation round boundary); False on a structurally invalid
        record or write failure — live serving never crashes on a bad
        disk, it just loses restart-resume."""
        rec = {"schema_version": SCHEMA_VERSION,
               "created_at": time.time(), **record}
        if self._check_overlay(rec) is not None:
            self.stats.save_fails += 1
            return False
        try:
            self._atomic_write(
                self._overlay_path(rec["base_fingerprint"]),
                json.dumps(rec, separators=(",", ":")).encode())
        except OSError:
            self.stats.save_fails += 1
            return False
        self.stats.saves += 1
        return True

    def load_overlay(self, base_fingerprint: str) -> dict | None:
        """The persisted overlay record for this base graph, or None
        (counted) — feed it to `DeltaOverlay.from_record` to resume."""
        path = self._overlay_path(base_fingerprint)
        if not os.path.exists(path):
            self.stats.misses += 1
            return None
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, json.JSONDecodeError):
            self.stats.reject("overlay_corrupt")
            return None
        reason = self._check_overlay(rec, base_fingerprint)
        if reason is not None:
            self.stats.reject(reason)
            return None
        self.stats.loads += 1
        return rec

    # -------------------------------------------------------------- fsck
    def fsck(self) -> dict:
        """Re-prove every on-disk record sound; quarantine what fails.

        Runs the analysis soundness pass (`verify_plan`) over each plan
        record and structural validation over each stats and live-overlay
        record, MOVING failures into `<vdir>/quarantine/` so they stop
        being served but stay inspectable.  Counted, never raised — fsck
        on a damaged store must report, not crash (same policy as load).
        Returns {"checked", "quarantined", "stats_checked",
        "overlays_checked", "findings"} with `findings` keyed by digest.
        """
        from ..analysis.findings import ERROR, Finding, has_errors
        from ..analysis.soundness import verify_plan

        report = {"checked": 0, "quarantined": 0, "stats_checked": 0,
                  "overlays_checked": 0, "findings": {}}
        with get_tracer().span("store.fsck", root=self.root) as fsp:
            for version, vdir in self._version_dirs():
                for fname in sorted(os.listdir(vdir)):
                    if not fname.endswith(".json"):
                        continue
                    digest = fname[: -len(".json")]
                    findings: list[Finding] = []
                    if fname.startswith("stats-"):
                        if version != SCHEMA_VERSION:
                            continue    # legacy stats: stale, not unsound
                        report["stats_checked"] += 1
                        fp = fname[len("stats-"): -len(".json")]
                        if self.load_graph_stats(fp) is None:
                            findings.append(Finding(
                                ERROR, "stats-record", digest,
                                "stats record is corrupt or its fingerprint "
                                "does not match its filename"))
                    elif fname.startswith("live-"):
                        if version != SCHEMA_VERSION:
                            continue  # legacy overlay: stale, not unsound
                        report["overlays_checked"] += 1
                        fp = fname[len("live-"): -len(".json")]
                        if self.load_overlay(fp) is None:
                            findings.append(Finding(
                                ERROR, "overlay-record", digest,
                                "live-overlay record is corrupt, claims "
                                "unnormalized/overlapping edge sets, or "
                                "its base fingerprint does not match its "
                                "filename"))
                    else:
                        report["checked"] += 1
                        findings = self._fsck_record(
                            digest, verify_plan, version=version, vdir=vdir)
                    if has_errors(findings):
                        report["findings"][digest] = findings
                        if self._quarantine(digest, vdir):
                            report["quarantined"] += 1
            fsp.set(checked=report["checked"],
                    quarantined=report["quarantined"])
        return report

    def _fsck_record(self, digest: str, verify_plan, *,
                     version: int = SCHEMA_VERSION,
                     vdir: str | None = None) -> list:
        from ..analysis.findings import ERROR, WARNING, Finding

        try:
            with open(self._path(digest, vdir)) as f:
                rec = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return [Finding(ERROR, "record-corrupt", digest,
                            f"unreadable record: {e}")]
        if version != SCHEMA_VERSION and self._record_labeled(rec):
            return [Finding(
                ERROR, "record-version-labeled", digest,
                f"schema v{version} record claims v2 label fields; no "
                f"v{version} writer could have produced it")]
        try:
            pattern = Pattern.from_dict(rec["pattern"])
            plan = plan_from_dict(rec["plan"])
        except (KeyError, TypeError, ValueError) as e:
            return [Finding(ERROR, "record-corrupt", digest,
                            f"pattern/plan does not round-trip: {e}")]
        out = verify_plan(plan, mode=str(rec.get("mode", "graphpi")),
                          location=digest)
        # the key↔pattern check is what pins labels to the slot: a
        # label flip can leave the plan internally sound (verify_plan
        # green) while the record now answers a DIFFERENT typed query
        # than the digest it is filed under
        if self._key_mismatch(rec, pattern, plan.pattern):
            out.append(Finding(
                ERROR, "key-pattern-mismatch", digest,
                "stored pattern/plan does not canonicalize to the "
                "record's own key: the record would serve another "
                "isomorphism class's (or label assignment's) slot"))
        reason = self._check_header(rec, expect_version=version)
        if reason is not None:
            # stale ≠ unsound: the loader already rejects these, so fsck
            # only reports them (re-warming overwrites in place)
            out.append(Finding(
                WARNING, "record-stale", digest,
                f"header mismatch ({reason}); record is skipped by the "
                f"loader until re-warmed"))
        return out

    def _quarantine(self, digest: str, vdir: str | None = None) -> bool:
        vdir = vdir or self.vdir
        qdir = os.path.join(vdir, "quarantine")
        json_path = self._path(digest, vdir)
        try:
            os.makedirs(qdir, exist_ok=True)
            os.replace(json_path,
                       os.path.join(qdir, os.path.basename(json_path)))
        except OSError:
            self.stats.reject("quarantine_fail")
            return False
        return True
