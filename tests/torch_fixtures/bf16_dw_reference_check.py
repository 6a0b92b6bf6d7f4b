"""Does the JAX reference's own bf16 dW_hh meet the 1e-3 bound that the
card tests hold the port's kernels to? On the CPU:

    python tests/torch_fixtures/bf16_dw_reference_check.py --hid 5280 --n 5 [--t 2] [--seed S]

For one bf16 biGRU layer at (T, N, H), with operands made by numpy from
``--seed`` (default H + N), prints one JSON line: the largest error of the
JAX package's dW (``gru_recurrence4(..., jnp.bfloat16, True)``'s VJP, the
Pallas kernel in interpret mode) against the port's plain version
(``ops.gru.gru_bwd_reference``: the same bf16 rounding points, float32
sums in torch's order) on the same saved ``ys`` (JAX's), as a multiple of
1e-3 of the largest dW entry, the entries past that bound, the share of
``dpx`` that rounds to the other bf16 neighbour, and whether the port's
CPU twin (``ops.gru_bwd`` on CPU tensors) equals the plain version bit for
bit. Few rows and T = 2 make the case flip-prone: the second chain step's
rows have ``h_prev = 0``, so a dW entry sums N products, and one flipped
rounding of dph moves it by ``h_prev`` times one bf16 step of dph. H=5280
takes about 8 GB and 12 s here.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from ocrs_models_tpu.ops.pallas.gru_kernel4 import gru_recurrence4  # noqa: E402
from ocrs_models_torch.ops import gru_bwd, gru_bwd_reference  # noqa: E402


def _as_port(x) -> torch.Tensor:
    """A bf16 JAX array as the same bf16 tensor."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def dw_check(t: int, n: int, hid: int, seed: int) -> dict:
    """The JAX reference's and the port's CPU twin's bf16 dW against the
    plain version at (T, N, H) (see the module's docstring)."""
    rng = np.random.default_rng(seed)
    px_f, px_b = (rng.normal(size=(t, n, 3 * hid)).astype(np.float32) for _ in range(2))
    k = 1 / hid**0.5
    w = rng.uniform(-k, k, size=(2, hid, 3 * hid)).astype(np.float32)
    b = rng.uniform(-k, k, size=(2, 3 * hid)).astype(np.float32)
    dys = [jnp.asarray(rng.normal(size=(t, n, hid)), jnp.bfloat16) for _ in range(2)]
    pxs = [jnp.asarray(p, jnp.bfloat16) for p in (px_f, px_b)]
    ys_j, vjp = jax.vjp(lambda pf, pb, ww, bb: gru_recurrence4(pf, pb, ww, bb, jnp.bfloat16, True),
                        *pxs, jnp.asarray(w), jnp.asarray(b))
    grads_j = vjp(tuple(dys))
    args = (*map(_as_port, pxs), *map(_as_port, ys_j), *map(_as_port, dys), torch.from_numpy(w),
            torch.from_numpy(b))
    plain = gru_bwd_reference(*args)
    twin = gru_bwd(*args)
    dw_j, dw = np.asarray(grads_j[2]), plain[2].numpy()
    bound = 1e-3 * np.abs(dw).max()
    dpx_j = np.concatenate([np.asarray(g, np.float32) for g in grads_j[:2]])
    dpx = torch.cat(plain[:2]).float().numpy()
    return {"t": t, "n": n, "hid": hid, "seed": seed,
            "jax_dw_err_of_bound": float(np.abs(dw_j - dw).max() / bound),
            "jax_dw_entries_past_bound": int((np.abs(dw_j - dw) > bound).sum()),
            "jax_dpx_flipped_share": float((dpx_j != dpx).mean()),
            "twin_equals_plain": all(torch.equal(a, c) for a, c in zip(twin, plain))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--t", type=int, default=2)
    ap.add_argument("--n", type=int, default=5)
    ap.add_argument("--hid", type=int, default=5280)
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    seed = args.hid + args.n if args.seed is None else args.seed
    print(json.dumps(dw_check(args.t, args.n, args.hid, seed)), flush=True)


if __name__ == "__main__":
    main()
