"""The numbers that decide ``correct`` and how they are judged: each
number of a run's outputs against the plain reference
(``portbench/reference``) is held to a limit of its configuration
(``checks``), and a run is correct when every one is within its limit.

Label maps are compared as the share of picture elements that differ.  A
feature's error is measured against the reference's magnitude or, where
that is smaller, the median magnitude of its column, since some columns
are near zero for most segments.
"""

import math

import numpy as np


def mismatch(got, want):
    """Share of elements that differ."""
    return float(np.mean(np.asarray(got) != np.asarray(want)))


def feature_err(got, want):
    """Largest |got - want| over max(|want|, median |want| of its column)
    (NaN read as 0)."""
    got, want = np.nan_to_num(got), np.nan_to_num(want)
    scale = np.maximum(np.median(np.abs(want), axis=0), 1e-12)
    return float(np.max(np.abs(got - want)
                        / np.maximum(np.abs(want), scale[None, :])))


def max_abs(got, want):
    """Largest |got - want|."""
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64))))


def rel_max(got, want):
    """Largest |got - want| over the largest |want|."""
    return max_abs(got, want) / max(float(np.max(np.abs(want))), 1e-12)


def worst(per_item):
    """Each number's largest value over the items; a NaN wins."""
    out = {}
    for numbers in per_item:
        for name, v in numbers.items():
            prev = out.get(name, -math.inf)
            if not math.isnan(prev) and (math.isnan(v) or v > prev):
                out[name] = v
    return out


def judge(numbers, limits):
    """[(name, value, limit, ok)] of every limited number; a missing or NaN
    number fails."""
    return [(name, numbers.get(name, math.nan), limit,
             bool(numbers.get(name, math.nan) <= limit))
            for name, limit in limits.items()]
