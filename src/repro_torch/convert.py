"""Carry the reference's state across: graphs and plans.

Graphs and plans play the part that weights play in a model.  Both
helpers take plain numpy arrays / JSON-able dicts — what the reference
package's `GraphCSR` fields and `plan_to_dict` records are — so nothing
here imports the reference.
"""
from __future__ import annotations

import numpy as np

from .core.plan import MatchingPlan, plan_from_dict
from .graph.csr import GraphCSR


def graph_from_arrays(indptr, indices, degrees, labels=None, *,
                      name: str = "") -> GraphCSR:
    """The port's GraphCSR over the reference's CSR arrays (indptr
    [n+1], sentinel-padded indices, degrees [n], optional labels [n]).
    The arrays are copied as int32, so the fingerprint matches the
    reference's for the same graph."""
    indptr = np.array(indptr, dtype=np.int32)
    indices = np.array(indices, dtype=np.int32)
    degrees = np.array(degrees, dtype=np.int32)
    n = len(indptr) - 1
    if degrees.shape != (n,):
        raise ValueError(f"degrees shape {degrees.shape} != ({n},)")
    if not np.array_equal(np.diff(indptr), degrees):
        raise ValueError("degrees disagree with indptr")
    if len(indices) < int(indptr[-1]):
        raise ValueError("indices shorter than indptr[-1]")
    if labels is not None:
        labels = np.array(labels, dtype=np.int32)
        if labels.shape != (n,):
            raise ValueError(f"labels shape {labels.shape} != ({n},)")
    return GraphCSR(n=n, m=int(indptr[-1]) // 2, indptr=indptr,
                    indices=indices, degrees=degrees, name=name,
                    labels=labels)


def plan_from_reference(d: dict) -> MatchingPlan:
    """A port MatchingPlan from the reference's `plan_to_dict` record
    (the record format is shared, so this is `plan_from_dict`)."""
    return plan_from_dict(d)
