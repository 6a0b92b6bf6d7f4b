"""Connected-component labeling and oriented word quads (counterpart of
``ocrs_models_tpu/geometry/components.py``): label the 8-connected
components of the binary text mask, then fit the minimum-area rotated
rectangle to each component's boundary pixels.
"""

from __future__ import annotations

import numpy as np

from . import native
from .polygon import min_area_rect


def connected_components_numpy(fg: np.ndarray) -> tuple[np.ndarray, int]:
    """Two-pass union-find over row runs (8-connectivity) of a boolean
    ``[H, W]`` mask; ``(labels int32, n)`` with 0 = background."""
    h, w = fg.shape
    labels = np.zeros((h, w), dtype=np.int32)
    parent: list[int] = [0]

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    def union(x: int, y: int) -> None:
        rx, ry = find(x), find(y)
        if rx != ry:
            parent[max(rx, ry)] = min(rx, ry)

    prev_runs: list[tuple[int, int, int]] = []  # (start, end, label)
    for y in range(h):
        row = fg[y]
        if not row.any():
            prev_runs = []
            continue
        diff = np.diff(row.astype(np.int8))
        starts = list(np.flatnonzero(diff == 1) + 1)
        ends = list(np.flatnonzero(diff == -1) + 1)
        if row[0]:
            starts.insert(0, 0)
        if row[-1]:
            ends.append(w)
        runs = []
        for s, e in zip(starts, ends):
            label = 0
            # Previous-row runs touching [s-1, e+1) are 8-connected.
            for ps, pe, pl in prev_runs:
                if pe >= s and ps <= e:
                    if label == 0:
                        label = pl
                    else:
                        union(label, pl)
            if label == 0:
                parent.append(len(parent))
                label = len(parent) - 1
            labels[y, s:e] = label
            runs.append((s, e, label))
        prev_runs = runs

    remap = np.zeros(len(parent), dtype=np.int32)
    next_id = 0
    for i in range(1, len(parent)):
        if find(i) == i:
            next_id += 1
            remap[i] = next_id
    for i in range(1, len(parent)):
        remap[i] = remap[find(i)]
    return remap[labels], next_id


def connected_components(mask: np.ndarray) -> tuple[np.ndarray, int]:
    """Label 8-connected components of an ``[H, W]`` binary mask."""
    m = np.asarray(mask)
    if m.ndim != 2:
        raise ValueError(f"expected an HxW mask, got shape {m.shape}")
    if native.available():
        return native.cc_label(m)
    return connected_components_numpy(m > 0)


def extract_cc_quads(mask: np.ndarray) -> np.ndarray:
    """``Nx4x2`` float32 min-area-rect quads, one per connected component."""
    labels, n = connected_components(mask)
    if n == 0:
        return np.zeros((0, 4, 2), dtype=np.float32)
    # The hull of the boundary pixels (a 4-neighbour differs) is the
    # hull of the component.
    fg = labels > 0
    interior = np.zeros_like(fg)
    interior[1:-1, 1:-1] = (
        fg[1:-1, 1:-1] & fg[:-2, 1:-1] & fg[2:, 1:-1] & fg[1:-1, :-2] & fg[1:-1, 2:]
    )
    ys, xs = np.nonzero(fg & ~interior)
    ls = labels[ys, xs]
    order = np.argsort(ls, kind="stable")
    ys, xs, ls = ys[order], xs[order], ls[order]
    splits = np.searchsorted(ls, np.arange(2, n + 1))
    quads = [
        min_area_rect(np.stack([cx, cy], axis=1).astype(np.float64))
        for cx, cy in zip(np.split(xs, splits), np.split(ys, splits))
    ]
    return np.stack(quads).astype(np.float32)
