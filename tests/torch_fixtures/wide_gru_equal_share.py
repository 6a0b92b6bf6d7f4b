"""How much of the bf16 biGRU backward's ``dpx`` can a right kernel be
expected to round exactly as the plain version does? On one NVIDIA GPU:

    python tests/torch_fixtures/wide_gru_equal_share.py

At T=257, N=128 and H = 256 (the cluster kernels), 264 and 512 (the wide
route), in bf16, prints one JSON line per width with the share of ``dpx``
elements equal to the plain version's (``ops.gru.gru_bwd_reference``) for
three computations on the same inputs: the kernel (``ops.gru_bwd``); the
plain chain with its products summed in float64 ("order": a right chain
that sums in another order, the noise floor of the comparison); and the
plain chain multiplying the unrounded ``dph`` ("unrounded": the wrong
rounding point, which the share must tell apart). The shares of the two
directions are given separately. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from ocrs_models_torch.ops import _build, gru  # noqa: E402

BF16 = torch.bfloat16


def _case(t: int, n: int, h: int, seed: int, dev) -> tuple:
    g = torch.Generator().manual_seed(seed)
    k = 1.0 / h**0.5
    px_f, px_b = (torch.randn((t, n, 3 * h), generator=g).to(dev, BF16) for _ in range(2))
    w_hh = ((torch.rand((2, h, 3 * h), generator=g) * 2 - 1) * k).to(dev)
    b_hh = ((torch.rand((2, 3 * h), generator=g) * 2 - 1) * k).to(dev)
    dy_f, dy_b = ((torch.randn((t, n, h), generator=g) * 0.1).to(dev, BF16) for _ in range(2))
    return px_f, px_b, w_hh, b_hh, dy_f, dy_b


def _chain_dpx(coef, dy_f, dy_b, w_hh, mode: str):
    """``gru_bwd_chain_reference``'s dpx with its product changed: "order"
    sums ``bf16(dph) @ bf16(W_hh)^T`` in float64, "unrounded" multiplies
    the unrounded dph."""
    t_len, n, hid = dy_f.shape
    dpx = [dy_f.new_empty((t_len, n, 3 * hid)) for _ in range(2)]
    dh = coef.new_zeros((2, n, hid))
    w_t = _build.rounded(w_hh, BF16).transpose(1, 2)
    for step in range(t_len):
        tf, tb = t_len - 1 - step, step
        cz, ca, cb, cr, cc = torch.stack([coef[0, tf], coef[1, tb]]).unbind(dim=2)
        dht = dh + torch.stack([dy_f[tf], dy_b[tb]]).float()
        da_c = dht * ca
        da_z = dht * cb
        dhn = da_c * cr
        da_r = da_c * cc
        d = torch.cat([da_r, da_z, da_c], dim=-1)
        dpx[0][tf], dpx[1][tb] = d[0], d[1]
        dph = torch.cat([da_r, da_z, dhn], dim=-1)
        if mode == "order":
            prod = torch.bmm(_build.rounded(dph, BF16).double(), w_t.double()).float()
        else:
            prod = torch.bmm(dph, w_t)
        dh = dht * cz + prod
    return dpx


def _shares(got, want) -> list[float]:
    return [(a == b).float().mean().item() for a, b in zip(got, want)]


def main() -> int:
    if not torch.cuda.is_available():
        print("wide_gru_equal_share: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    for t, n, h in ((257, 128, 256), (257, 128, 264), (257, 128, 512)):
        px_f, px_b, w_hh, b_hh, dy_f, dy_b = _case(t, n, h, t + n + h, dev)
        ys = gru.gru_fwd(px_f, px_b, w_hh, b_hh)
        args = (px_f, px_b, *ys, dy_f, dy_b, w_hh, b_hh)
        want = gru.gru_bwd_reference(*args)[:2]
        coef = gru.gru_bwd_coefficients_reference(px_f, px_b, *ys, w_hh, b_hh)
        line = {"T": t, "N": n, "H": h, "route": gru.gru_route(h),
                "kernel": _shares(gru.gru_bwd(*args)[:2], want)}
        for mode in ("order", "unrounded"):
            line[mode] = _shares(_chain_dpx(coef, dy_f, dy_b, w_hh, mode), want)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
