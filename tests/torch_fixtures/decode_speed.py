"""Time the port's image decoder (``ocrs_models_torch.data.imageio``)
against Pillow's ``Image.open(...).convert("L")`` (libjpeg-turbo's SIMD
path) on the committed fixtures, in one process on this host's CPU:

    python tests/torch_fixtures/decode_speed.py [--repeats 20]

Prints one JSON line per file set: the megapixels, each decoder's median
ms per megapixel over the repeats, and their ratio. Without Pillow it
times the port's decoder alone.
"""

from __future__ import annotations

import argparse
import io
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from ocrs_models_torch.data.imageio import decode_jpeg_grey  # noqa: E402

DATA = ROOT / "tests" / "data"


def _median_ms(fn, datas, repeats: int) -> float:
    fn(datas[0])  # warm-up (and the codec's build)
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for d in datas:
            fn(d)
        runs.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(runs)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=20)
    args = parser.parse_args(argv)
    try:
        from PIL import Image
    except ImportError:
        Image = None

    sets = {"2 MP page (1648x1236, 4:2:0, q90)": [DATA / "torch_decode_page.jpg"],
            "HierText toy pages (8)": sorted((DATA / "torch_hiertext_toy").rglob("*.jpg"))}
    for name, paths in sets.items():
        datas = [p.read_bytes() for p in paths]
        mp = sum(decode_jpeg_grey(d).size for d in datas) / 1e6
        port = _median_ms(decode_jpeg_grey, datas, args.repeats)
        line = {"files": name, "megapixels": mp, "port_ms_per_mp": port / mp}
        if Image is not None:
            def pillow(d):
                with Image.open(io.BytesIO(d)) as img:
                    return img.convert("L")

            pil = _median_ms(pillow, datas, args.repeats)
            line.update(pillow_ms_per_mp=pil / mp, port_over_pillow=port / pil)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
