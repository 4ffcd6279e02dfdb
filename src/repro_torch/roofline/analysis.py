"""Roofline terms of a dry-run cell (`launch.dryrun`): the counterpart
of `repro/roofline/analysis.py`.

    compute    = FLOPs_per_device            / peak bf16 FLOP/s
    memory     = bytes_per_device            / HBM bytes/s
    collective = collective_bytes_per_device / NVLink bytes/s (one way)

over one NVIDIA H100's published rates (`launch.mesh.HW`).  The terms
come from one rank's step recorded by `roofline.op_cost.OpCost` (the
reference parses XLA's compiled HLO instead); a rank's numbers are the
per-device ones, so global = per-device × chips as in the reference.
The reference's `raw_cost_flops` / `raw_cost_bytes` (XLA's own
aggregates, kept beside its walk) have no counterpart here.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field

from ..launch.mesh import HW


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: dict = field(default_factory=dict)
    model_flops: float = 0.0          # 6·N·D (train) / 2·N·D (serve), global
    peak_memory_bytes: float = 0.0    # arguments + high-water, per device

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / HW["peak_flops_bf16"]

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HW["hbm_bw"]

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_device / HW["link_bw"]

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def step_time_s(self) -> float:
        """Lower-bound step time: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the lower-bound step
        time, counting only MODEL (useful) flops: how close the cell is to
        'useful compute at peak'."""
        if self.step_time_s == 0:
            return 0.0
        useful_per_chip = self.model_flops / self.chips
        return (useful_per_chip / self.step_time_s) / HW["peak_flops_bf16"]

    def to_json(self) -> dict:
        d = asdict(self)
        d.update(
            compute_s=self.compute_s,
            memory_s=self.memory_s,
            collective_s=self.collective_s,
            bottleneck=self.bottleneck,
            useful_flops_ratio=self.useful_flops_ratio,
            step_time_s=self.step_time_s,
            roofline_fraction=self.roofline_fraction,
        )
        return d


def analyze(arch, shape, mesh_name, chips, record, model_flops) -> Roofline:
    """The terms of one recorded step (`roofline.op_cost.OpCost`: the
    port's counterpart of the reference's `compiled`); K4's FLOP are in
    the record already (its wrapper reports them), where the reference
    adds them as `extra_flops_per_device`."""
    return Roofline(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        flops_per_device=record.flops,
        bytes_per_device=record.bytes_,
        coll_bytes_per_device=float(sum(record.coll.values())),
        coll_breakdown=dict(record.coll),
        model_flops=model_flops,
        peak_memory_bytes=float(record.peak_bytes),
    )
