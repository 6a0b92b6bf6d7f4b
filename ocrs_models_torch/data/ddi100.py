"""DDI-100 detection pages (the port's copy of
``ocrs_models_tpu/data/ddi100.py``).

Distorted Document Images: page images in ``gen_imgs/`` with pickled word
quads in ``gen_boxes/``. Pickles can run arbitrary code and this is
third-party data, so the unpickler admits numpy's array reconstruction
globals and nothing else. Pages are read by :func:`imageio.read_grey`
(PNG, or JPEG whatever the file's name).
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from ..geometry import generate_mask
from .imageio import read_grey


def _reconstruct():
    try:  # numpy >= 2
        from numpy._core.multiarray import _reconstruct as fn
    except ImportError:
        from numpy.core.multiarray import _reconstruct as fn
    return fn


class RestrictedUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays and dtypes; any other global raises
    ``pickle.UnpicklingError``."""

    def find_class(self, module, name):
        path = f"{module}.{name}"
        if path == "numpy.dtype":
            return np.dtype
        if path == "numpy.ndarray":
            return np.ndarray
        if path in ("numpy.core.multiarray._reconstruct", "numpy._core.multiarray._reconstruct"):
            return _reconstruct()
        raise pickle.UnpicklingError(f"Disallowed class {path}")


class DDI100:
    """Detection samples ``{"image", "mask", "path"}``; the first 90% of the
    page names in sorted order train, the rest validate."""

    def __init__(
        self,
        root_dir: str,
        train: bool = True,
        transform=None,
        max_images: Optional[int] = None,
        shrink_dist: float = 3.0,
    ):
        self._img_dir = f"{root_dir}/gen_imgs"
        self._boxes_dir = f"{root_dir}/gen_boxes"
        if not os.path.exists(self._img_dir):
            raise FileNotFoundError(f"Dataset images not found in {self._img_dir}")
        if not os.path.exists(self._boxes_dir):
            raise FileNotFoundError(f"Dataset masks not found in {self._boxes_dir}")
        names = sorted(os.listdir(self._img_dir))
        if max_images is not None:
            names = names[:max_images]
        split = int(len(names) * 0.9)
        self._img_filenames = names[:split] if train else names[split:]
        self.transform = transform
        self.shrink_dist = shrink_dist

    def __len__(self):
        return len(self._img_filenames)

    def __getitem__(self, idx: int) -> dict:
        fname = self._img_filenames[idx]
        base, _ = os.path.splitext(fname)
        img_path = f"{self._img_dir}/{fname}"
        image = (read_grey(img_path).astype(np.float32) / 255.0 - 0.5)[..., None]
        with open(f"{self._boxes_dir}/{base}.pickle", "rb") as f:
            words = RestrictedUnpickler(f).load()
        # DDI-100 stores the quads' corners as (y, x); swap to (x, y).
        polys = [[(float(c[1]), float(c[0])) for c in w["box"]] for w in words]
        h, w = image.shape[:2]
        mask = generate_mask(w, h, polys, shrink_dist=self.shrink_dist)[..., None]
        if self.transform:
            if getattr(self.transform, "accepts_index", False):
                image, mask = self.transform(image, mask, idx=idx)
            else:
                image, mask = self.transform(image, mask)
        return {"image": image, "mask": mask, "path": img_path}
