"""The comparisons that decide `correct`, shared by the drivers."""

from __future__ import annotations

import statistics

LEAF_FLOOR = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's


def _f(x) -> float:
    return float(x)


def moved(ref_grad: dict) -> list[str]:
    """The leaves the reference's gradient moves: at least a thousandth of
    the median leaf's norm. The rest move by rounding alone."""
    med = statistics.median(_f(v) for v in ref_grad.values())
    return [k for k, v in ref_grad.items() if _f(v) >= LEAF_FLOOR * med]


def rel_gap(got, want) -> float:
    """The largest |got - want| / |want| over paired scalars."""
    return max(abs(_f(g) - _f(w)) / abs(_f(w)) for g, w in zip(got, want, strict=True))


def leaf_gaps(got: dict, want: dict, keep) -> dict:
    """{leaf: the gap between the program's and the reference's norm of the
    leaf, over the reference's norm of that leaf or of the median leaf,
    whichever is larger}. A leaf the program has no reading of reads 0."""
    med = statistics.median(_f(want[k]) for k in keep)
    return {k: abs(_f(got.get(k, 0.0)) - _f(want[k])) / max(_f(want[k]), med) for k in keep}


def leaf_gap(got: dict, want: dict, keep, at: str = "worst") -> float:
    """`leaf_gaps` at the worst leaf, or at the median leaf."""
    gaps = leaf_gaps(got, want, keep).values()
    return max(gaps) if at == "worst" else statistics.median(gaps)
