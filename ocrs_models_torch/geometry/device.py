"""Batched connected components and component bounds on the device
(counterpart of ``ocrs_models_tpu/geometry/device.py``).

The labels and boxes are those of the JAX package: each 8-connected
component is labelled by its largest flat pixel index + 1 (not compacted),
and the boxes are axis-aligned. The oriented word quads stay on the host
(:mod:`ocrs_models_torch.geometry.components`); this path serves batches
where boxes suffice, and its labels can feed either.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import as_device_tensor

CHECK_EVERY = 16
"""Propagation steps between two tests for the fixed point. A test waits
for the device and takes about as long as a step at 4 x 800x600 (phase
17 of ``chip_smoke.py`` times both), so testing every 16 steps adds a
few percent and runs at most 15 steps past the fixed point. Labels only
grow, so equal labels after 16 steps mean that none of them changed
anything: the result is the one a test after every step gives."""

_MAX_PIXELS = 1 << 24  # labels are propagated in float32: exact integers up to 2^24
_SPREAD = 4096  # spare columns of component_bounds_device's scatters


def _propagate(labels: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    """One step: each foreground pixel takes the largest label of its 3x3
    neighbourhood. ``labels`` is float32 ``[N, 1, H, W]``."""
    return torch.where(fg, F.max_pool2d(labels, 3, stride=1, padding=1), 0.0)


def connected_components_device(masks, device="cuda") -> torch.Tensor:
    """Label the 8-connected components of a batch of binary masks.

    :param masks: ``[N, H, W]`` (bool or 0/1), moved to ``device``.
    :return: ``[N, H, W]`` int32 labels, 0 = background; each component is
        labelled by its largest flat index ``y * W + x`` plus 1.

    Max-propagation to a fixed point: O(component diameter) steps.
    """
    fg = as_device_tensor(masks, device)[:, None] != 0
    n, _, h, w = fg.shape
    if h * w > _MAX_PIXELS:
        raise ValueError(f"connected_components_device: {h}x{w} masks exceed 2^24 pixels, "
                         "beyond which float32 labels would round")
    index = torch.arange(1, h * w + 1, dtype=torch.float32, device=fg.device).view(1, 1, h, w)
    labels = torch.where(fg, index, 0.0)
    while True:
        before = labels
        for _ in range(CHECK_EVERY):
            labels = _propagate(labels, fg)
        if torch.equal(labels, before):
            return labels[:, 0].to(torch.int32)


def component_bounds_device(labels, max_components: int,
                            device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Axis-aligned bounds of up to ``max_components`` (K) components a mask.

    :param labels: ``[N, H, W]`` int32 from :func:`connected_components_device`.
    :return: ``(boxes, valid)``: ``boxes`` ``[N, K, 4]`` int32 ``(x0, y0, x1,
        y1)`` inclusive, zeros where invalid; ``valid`` ``[N, K]`` bool. Slot
        ``k`` holds the component of the ``k``-th smallest label; with more
        than K components, slots ``0..K-2`` hold the K-1 smallest labels and
        slot ``K-1`` the largest, as in the JAX package.
    """
    if max_components < 1:
        raise ValueError(f"component_bounds_device: max_components={max_components} < 1")
    lab = as_device_tensor(labels, device)
    n, h, w = lab.shape
    size = h * w + 1  # a column per possible label, 0 = background
    if lab.numel() and not (lab.min() >= 0 and lab.max() < size):
        raise ValueError(f"component_bounds_device: labels outside [0, {size - 1}]")
    lab = lab.long()
    # Only the first pixel of a row's run of one label can hold the label's
    # smallest x, only the last its largest; each run's y is its row's. So
    # the scatters below take one pixel at each end of a run, a few per row
    # of a component rather than all its pixels: atomics on one label's
    # entry then wait for each other far less. The other pixels go to
    # _SPREAD spare columns, cut off after.
    first = (lab != F.pad(lab, (1, 0))[..., :-1]) & (lab > 0)
    last = (lab != F.pad(lab, (0, 1))[..., 1:]) & (lab > 0)
    pos = torch.arange(h * w, device=lab.device)
    spare = size + pos % _SPREAD
    xy = torch.stack([pos % w, pos // w]).expand(n, 2, h * w)  # x, y of each pixel
    width = size + _SPREAD
    lo = torch.full((n, 2, width), size, dtype=torch.long, device=lab.device)
    hi = torch.full((n, 2, width), -1, dtype=torch.long, device=lab.device)
    for table, ends, reduce in ((lo, first, "amin"), (hi, last, "amax")):
        index = torch.where(ends.reshape(n, h * w), lab.reshape(n, h * w), spare)
        table.scatter_reduce_(2, index[:, None].expand(n, 2, h * w), xy, reduce)

    # Slot k takes the label of rank k, slot K-1 the largest once more than
    # K are present: the first label at which the running count of present
    # labels reaches the slot's rank + 1.
    seen = torch.cumsum(hi[:, 0, :size] >= 0, dim=1)  # present labels up to each label
    count = seen[:, -1:]
    rank = torch.arange(max_components, device=lab.device).expand(n, max_components).clone()
    rank[:, -1] = torch.maximum(rank[:, -1], count[:, 0] - 1)
    valid = rank < count
    table = torch.where(valid, torch.searchsorted(seen, rank + 1), 0)
    idx = table[:, None].expand(n, 2, max_components)
    boxes = torch.cat([lo.gather(2, idx), hi.gather(2, idx)], dim=1).transpose(1, 2)
    return torch.where(valid[..., None], boxes, 0).to(torch.int32), valid
