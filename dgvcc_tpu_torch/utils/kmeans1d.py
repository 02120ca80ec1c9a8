"""Exact (globally optimal) 1-D k-means, a copy of the numpy path of
dgvcc_tpu/utils/kmeans1d.py.

``cluster(values, k) -> (labels, centroids)`` with clusters ordered by
ascending centroid (label 0 = lowest), the interface of the ``kmeans1d``
package the reference uses for ISW's sensitive-covariance selection
(models/ISW/cov_settings.py:4,58). A dynamic programme over the sorted
values, each layer solved by divide and conquer over the optimal split.
The ISW tracker calls it only at ``relax_denom: 0``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _sse_prefix(v: np.ndarray):
    s = np.concatenate([[0.0], np.cumsum(v)])
    s2 = np.concatenate([[0.0], np.cumsum(v * v)])
    return s, s2


def _cluster_sorted(v: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Labels and centroids of sorted values ``v``."""
    n = len(v)
    s, s2 = _sse_prefix(v)

    def sse(j, i):  # j may be an array; i is a scalar
        cnt = i - j + 1
        su = s[i + 1] - s[j]
        return np.maximum(s2[i + 1] - s2[j] - su * su / cnt, 0.0)

    prev = sse(np.zeros(n, np.int64), np.arange(n))  # layer 0: one cluster
    args = np.zeros((k, n), np.int64)
    for m in range(1, k):
        head = np.full(n + 1, np.inf)
        head[1:] = prev  # head[j] = cost of the first j points in m clusters
        cur = np.full(n, np.inf)
        stack = [(m, n - 1, m, n - 1)]
        while stack:
            lo, hi, optlo, opthi = stack.pop()
            if lo > hi:
                continue
            mid = (lo + hi) // 2
            js = np.arange(optlo, min(mid, opthi) + 1)
            costs = head[js] + sse(js, mid)
            t = int(np.argmin(costs))
            bestj = optlo + t
            cur[mid] = costs[t]
            args[m, mid] = bestj
            stack.append((lo, mid - 1, optlo, bestj))
            stack.append((mid + 1, hi, bestj, opthi))
        prev = cur

    labels = np.zeros(n, np.int32)
    centroids = np.zeros(k, np.float64)
    i = n - 1
    for m in range(k - 1, -1, -1):
        j = 0 if m == 0 else int(args[m, i])
        centroids[m] = (s[i + 1] - s[j]) / (i - j + 1)
        labels[j:i + 1] = m
        i = j - 1
    return labels, centroids


def cluster(values, k: int) -> Tuple[List[int], List[float]]:
    """(labels in input order, centroids ascending); k is capped at the
    number of values."""
    v = np.asarray(values, np.float64).ravel()
    n = len(v)
    if n == 0:
        return [], []
    k = max(1, min(int(k), n))
    order = np.argsort(v, kind="stable")
    labels_sorted, centroids = _cluster_sorted(np.ascontiguousarray(v[order]), k)
    labels = np.empty(n, np.int32)
    labels[order] = labels_sorted
    return labels.tolist(), centroids.tolist()
