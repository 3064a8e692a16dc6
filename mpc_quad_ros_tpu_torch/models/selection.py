"""Dataset curation: pruning and training-point selection heuristics.

Counterpart of ``mpc_quad_ros_tpu/models/selection.py``, the same numpy and
scipy code (the JAX package's ``models/__init__`` imports JAX, so the port
keeps its own copy): ``prune_dataset``, ``distance_maximizing_points_1d``,
``distance_maximizing_points_2d``, the dimension dispatcher
``distance_maximizing_points`` and ``sample_random_points``.  They curate
logged flight data into GP training sets on the host; given the same
``numpy.random.Generator`` they pick the JAX package's indices.
"""

from __future__ import annotations

import numpy as np


def prune_dataset(x: np.ndarray, y: np.ndarray, x_cap: float, bins: int,
                  thresh: float, plot: bool = False, labels=None) -> np.ndarray:
    """Two-stage pruning of a model-error dataset (`utils.py:460-535`).

    1. Drop rows where any input feature exceeds ±x_cap.
    2. Per output axis, histogram the labels into `bins` bins and drop rows
       falling in bins holding less than `thresh` (ratio) of the samples —
       removing sparse outlier errors.

    Returns the indices (into the original arrays) that survive.
    """
    x, y = np.asarray(x), np.asarray(y)
    keep = np.all(np.abs(x) <= x_cap, axis=1)
    idx = np.where(keep)[0]

    for d in range(y.shape[1]):
        yd = y[idx, d]
        counts, edges = np.histogram(yd, bins=bins)
        which = np.clip(np.digitize(yd, edges) - 1, 0, bins - 1)
        dense = counts[which] >= thresh * len(yd)
        idx = idx[dense]

    if plot:  # diagnostic only
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, y.shape[1], figsize=(4 * y.shape[1], 3))
        axes = np.atleast_1d(axes)
        for d, a in enumerate(axes):
            a.hist(y[:, d], bins=bins, alpha=0.4, label="raw")
            a.hist(y[idx, d], bins=bins, alpha=0.7, label="kept")
            a.set_xlabel(labels[d] if labels else f"y[{d}]")
            a.legend()
        plt.show()
    return idx


def distance_maximizing_points_1d(points: np.ndarray, n_train_points: int,
                                  rng: np.random.Generator | None = None) -> np.ndarray:
    """Pick `n_train_points` spread across the 1-D data range by histogramming
    into that many bins and taking each bin's median sample
    (`utils.py:538-583`).  Empty bins fall back to a random sample.  Returns
    indices into `points`.
    """
    rng = rng or np.random.default_rng(0)
    points = np.asarray(points).ravel()
    _, edges = np.histogram(points, bins=n_train_points)
    which = np.clip(np.digitize(points, edges) - 1, 0, n_train_points - 1)
    out = np.empty(n_train_points, dtype=int)
    for i in range(n_train_points):
        members = np.where(which == i)[0]
        if members.size == 0:
            out[i] = rng.integers(0, points.size)
            continue
        # index of the member closest to the bin median
        med = np.median(points[members])
        out[i] = members[np.argmin(np.abs(points[members] - med))]
    return out


def distance_maximizing_points_2d(points: np.ndarray, n_train_points: int,
                                  rng: np.random.Generator | None = None) -> np.ndarray:
    """Coverage-maximizing selection in ≥2-D via k-means clustering: cluster
    into (up to) `n_train_points` groups and sample representatives from each
    (`utils.py:586-620`).  Returns indices into `points`.
    """
    rng = rng or np.random.default_rng(0)
    points = np.asarray(points, dtype=float)
    if n_train_points > 30:
        n_clusters = max(int(n_train_points / 10), 30)
        n_samples = int(np.floor(n_train_points / n_clusters))
    else:
        n_clusters = min(n_train_points, points.shape[0])
        n_samples = 1

    from scipy.cluster.vq import kmeans2

    _, assignment = kmeans2(points, n_clusters, minit="++", seed=rng.integers(2**31))
    chosen: list[int] = []
    for c in range(n_clusters):
        members = np.where(assignment == c)[0]
        if members.size == 0:
            members = np.arange(points.shape[0])
        chosen += rng.choice(members, n_samples).tolist()
    # trim any excess from the integer division
    while len(chosen) > n_train_points:
        chosen.pop(rng.integers(len(chosen)))
    return np.asarray(chosen, dtype=int)


def distance_maximizing_points(x_values: np.ndarray, n_train_points: int = 7,
                               rng: np.random.Generator | None = None) -> np.ndarray:
    """Dimension dispatcher (`utils.py:623-718`): 1-D data takes the histogram
    heuristic, ≥2-D the k-means heuristic."""
    x_values = np.asarray(x_values)
    if x_values.ndim == 1 or x_values.shape[1] == 1:
        return distance_maximizing_points_1d(x_values, n_train_points, rng)
    return distance_maximizing_points_2d(x_values, n_train_points, rng)


def sample_random_points(points: np.ndarray, used_idx: np.ndarray,
                         points_to_sample: int,
                         rng: np.random.Generator | None = None) -> np.ndarray:
    """Augment a selection with random points, biased toward sparse regions:
    sampling probability is inverse to the multi-dimensional histogram density
    (`utils.py:721-745`).  Returns the concatenated index set.
    """
    rng = rng or np.random.default_rng(0)
    points = np.atleast_2d(np.asarray(points, dtype=float))
    if points.shape[0] == 1 and points.shape[1] > points.shape[0]:
        points = points.T
    used_idx = np.asarray(used_idx, dtype=int)

    bins = int(np.clip(len(points) / 10, 2, 10))
    free = np.delete(np.arange(points.shape[0]), used_idx)
    n_samples = min(points_to_sample, len(free))
    if n_samples <= 0:
        return used_idx

    counts, edges = np.histogramdd(points[free], bins)
    assign = tuple(
        np.clip(np.digitize(points[free, j], edges[j]) - 1, 0, bins - 1)
        for j in range(points.shape[1])
    )
    probs = np.max(counts) - counts[assign]
    if probs.sum() <= 0:
        probs = np.ones_like(probs)
    probs = probs / probs.sum()
    picked = rng.choice(free, n_samples, p=probs, replace=False)
    return np.append(used_idx, picked)
