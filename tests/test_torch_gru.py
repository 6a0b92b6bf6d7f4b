"""Port's biGRU recurrence and ``BiGRU`` module vs the JAX package's
``gru_recurrence4`` (Pallas, interpret mode on CPU), its ``BiGRU`` on both
backends, and torch's own ``nn.GRU``, on the same numpy inputs; at the
shipped kind of width (H=16: the cluster route on the card) and at the
wide route's (H=12, not a multiple of 8; H=264 and 320, above 256); the
route and the wide route's zero padding; and the recognition weights'
strict load at other widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocrs_models_tpu.models import RecognitionModel as JaxRecognition
from ocrs_models_tpu.ops.gru import BiGRU as JaxBiGRU
from ocrs_models_tpu.ops.pallas.gru_kernel4 import gru_recurrence4
from ocrs_models_torch.models import RecognitionModel
from ocrs_models_torch.ops import (
    BiGRU,
    gru_bwd_chain_reference,
    gru_bwd_coef_wide_f32,
    gru_bwd_coefficients_reference,
    gru_bwd_dw_reference,
    gru_bwd_dw_wide_f32,
    gru_bwd_phases_reference,
    gru_bwd_reference,
    gru_recurrence,
    gru_recurrence_reference,
    gru_route,
)
from ocrs_models_torch.ops.gru import (
    GRID_F32_CHUNK,
    GRID_F32_MAX_HIDDEN,
    GRID_F32_RESIDENT_HIDDEN,
    GRID_F32_STAGE_BYTES,
    GRID_F32_STREAM_UNITS,
    GRID_F32_UNITS,
    GRID_GATE_CHAIN_CHUNK,
    GRID_GATE_UNITS,
    GRID_MAX_HIDDEN,
    GRID_MAX_UNITS,
    GRID_RESIDENT_HIDDEN,
    GRID_UNITS,
    H100_SMEM,
    H100_SMS,
    MAX_HIDDEN,
    MAX_WIDE_HIDDEN,
    GridF32Plan,
    GridF32Split,
    GridSplit,
    _dph,
    _dw_splits,
    _dw_wide_tiles,
    _pad_gates,
    _pad_w,
    _unpad_gates,
    bwd_phases,
    bwd_wide_f32_smem,
    grid_f32_plan,
    grid_chunk,
    grid_f32_kernel_smem,
    grid_f32_smem,
    grid_f32_stream_elems,
    grid_kernel_smem,
    grid_plan,
    grid_smem,
    tf32_split,
    tf32x3_matmul_reference,
)
from ocrs_models_torch.weights import bigru_state_dict_from_jax, recognition_state_dict_from_jax
from torch_fixtures.bf16_dw_reference_check import dw_check
from torch_port_common import random_variables

# (T, H) cases: H=16 as before (their ids kept), H=12, 264 and 320 on the
# wide route; T=7 at H=264 is left out (the Pallas kernel in interpret
# mode is the slow side there).
# T=3 at H=520 is the f32 grid form's width (gru_grid_f32.cu, above 512);
# at H=1451 (padded to 1456) that of its streamed plans.
WIDTH_CASES = [(1, 16), (7, 16), (33, 16), (1, 12), (7, 12), (33, 12), (1, 264), (33, 264),
               (3, 320), (3, 520), (3, 1451)]
WIDTH_IDS = ["1", "7", "33", "1-h12", "7-h12", "33-h12", "1-h264", "33-h264", "3-h320", "3-h520",
             "3-h1451"]


def _case(t, n=8, h=16, seed=0):
    # W_hh's scale falls as 1/sqrt(H), 0.3 at H=16, as nn.GRU's init
    # does, so that every width's recurrence is as well conditioned: at 0.3
    # and H=264 it is chaotic, and two float32 summation orders, 1e-7 apart
    # at the first step, end 5e-3 apart after 33 steps.
    rng = np.random.default_rng(seed)
    px_f = rng.normal(size=(t, n, 3 * h)).astype(np.float32)
    px_b = rng.normal(size=(t, n, 3 * h)).astype(np.float32)
    w = (rng.normal(size=(2, h, 3 * h)) * 0.3 * (16 / h) ** 0.5).astype(np.float32)
    b = (rng.normal(size=(2, 3 * h)) * 0.1).astype(np.float32)
    return px_f, px_b, w, b


@pytest.mark.parametrize("t,h", WIDTH_CASES, ids=WIDTH_IDS)
def test_recurrence_matches_pallas(t, h):
    args = _case(t, h=h)
    want_f, want_b = gru_recurrence4(*map(jnp.asarray, args), jnp.float32, True)
    got_f, got_b = gru_recurrence(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=0, atol=1e-5)


def _jax_bigru(backend, hidden=16, layers=2, feat=12, n=3, t=9, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, t, feat)).astype(np.float32)
    mod = JaxBiGRU(hidden, layers, compute_dtype=jnp.float32, backend=backend)
    params = mod.init(jax.random.key(seed), jnp.asarray(xs))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return mod, params, xs


def _port_bigru(params, feat=12, hidden=16, layers=2):
    m = BiGRU(feat, hidden, layers)
    m.load_state_dict(bigru_state_dict_from_jax(params), strict=True)
    return m


@pytest.mark.parametrize(
    "backend,hidden", [("scan", 16), ("pallas4", 16), ("scan", 12), ("pallas4", 12),
                       ("scan", 264), ("pallas4", 264)],
    ids=["scan", "pallas4", "scan-h12", "pallas4-h12", "scan-h264", "pallas4-h264"])
def test_bigru_matches_jax(backend, hidden):
    mod, params, xs = _jax_bigru(backend, hidden=hidden)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(xs)))
    with torch.no_grad():
        got = _port_bigru(params, hidden=hidden)(torch.from_numpy(xs)).numpy()
    assert got.shape == want.shape == (3, 9, 2 * hidden)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_bigru_matches_nn_gru():
    _, params, xs = _jax_bigru("scan", seed=1)
    port = _port_bigru(params)
    ref = torch.nn.GRU(12, 16, num_layers=2, bidirectional=True, batch_first=True)
    ref.load_state_dict(port.state_dict(), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(xs))
        want, _ = ref(torch.from_numpy(xs))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("t,h", WIDTH_CASES, ids=WIDTH_IDS)
def test_recurrence_gradients_match_pallas_vjp(t, h):
    # The port's backward on CPU (autograd of the plain recurrence, the
    # twin of gru_bwd.cu and of gru_wide.cu's route) against
    # gru_recurrence4's Pallas backward in interpret mode. Tolerance atol
    # 1e-5: float32, cotangents of order 1 summed over up to 33 steps.
    args = _case(t, h=h, seed=4)
    rng = np.random.default_rng(5)
    dys = [rng.normal(size=(t, 8, h)).astype(np.float32) for _ in range(2)]
    _, vjp = jax.vjp(lambda *a: gru_recurrence4(*a, jnp.float32, True), *map(jnp.asarray, args))
    want = vjp(tuple(map(jnp.asarray, dys)))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in args]
    outs = gru_recurrence(*ins)
    torch.autograd.backward(outs, [torch.from_numpy(d) for d in dys])
    for name, a, w in zip(("dpx_f", "dpx_b", "dw_hh", "db_hh"), ins, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("t", [1, 7, 33])
def test_backward_phases_match_autograd_and_pallas_vjp(t):
    # The backward as gru_bwd.cu computes it (coefficients over all rows,
    # then the chain, then the dW reduction), composed from the phases'
    # plain versions, against autograd of the plain recurrence and against
    # gru_recurrence4's Pallas backward in interpret mode. Tolerance atol
    # 1e-5: float32, cotangents of order 1 carried over up to 33 steps and
    # summed over up to 33 * 8 rows in another order.
    args = _case(t, seed=6)
    rng = np.random.default_rng(7)
    dys = [rng.normal(size=(t, 8, 16)).astype(np.float32) for _ in range(2)]
    _, vjp = jax.vjp(lambda *a: gru_recurrence4(*a, jnp.float32, True), *map(jnp.asarray, args))
    want_jax = vjp(tuple(map(jnp.asarray, dys)))
    px_f, px_b, w, b = map(torch.from_numpy, args)
    dy_f, dy_b = map(torch.from_numpy, dys)
    ys_f, ys_b = gru_recurrence_reference(px_f, px_b, w, b)
    got = gru_bwd_phases_reference(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w, b)
    want = gru_bwd_reference(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w, b)
    for name, g, a, j in zip(("dpx_f", "dpx_b", "dw_hh", "db_hh"), got, want, want_jax):
        assert g.shape == a.shape, name
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("t,n,h", [(2, 3, 8), (5, 17, 48)])
def test_backward_phases_match_autograd_at_ragged_shapes(t, n, h):
    # The shapes the kernel masks (N not a multiple of 16, H not of 32),
    # in float64 so that only the algebra is compared: atol 1e-12.
    rng = np.random.default_rng(t + n + h)
    px_f, px_b = (torch.from_numpy(rng.normal(size=(t, n, 3 * h))) for _ in range(2))
    w = torch.from_numpy(rng.normal(size=(2, h, 3 * h)) * 0.3)
    b = torch.from_numpy(rng.normal(size=(2, 3 * h)) * 0.1)
    dy_f, dy_b = (torch.from_numpy(rng.normal(size=(t, n, h))) for _ in range(2))
    ys_f, ys_b = gru_recurrence_reference(px_f, px_b, w, b)
    got = gru_bwd_phases_reference(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w, b)
    want = gru_bwd_reference(px_f, px_b, ys_f, ys_b, dy_f, dy_b, w, b)
    for name, g, a in zip(("dpx_f", "dpx_b", "dw_hh", "db_hh"), got, want):
        torch.testing.assert_close(g, a, rtol=0, atol=1e-12, msg=name)


# ------------------------------------------------------------ the wide route


def test_gru_route():
    # The cluster kernels' domain exactly (gru_cluster.cuh, shape_ok): H a
    # multiple of 8 from 8 to 256. Every other width is wide, by its width
    # padded to a multiple of 8: the persistent kernels ("wide", clusters
    # of up to 16 blocks) up to 512, the f32 grid form (gru_grid_f32.cu) up
    # to GRID_F32_MAX_HIDDEN (2112 on an H100: 66 unit tiles of 32 units,
    # 132 blocks; up to GRID_F32_RESIDENT_HIDDEN, 1056, all of W_hh
    # resident, above it partly streamed), one launch a step above.
    assert MAX_HIDDEN == 256 and MAX_WIDE_HIDDEN == 512 and GRID_F32_MAX_HIDDEN == 2112
    assert GRID_F32_RESIDENT_HIDDEN == 1056
    assert [gru_route(h) for h in (8, 16, 48, 128, 248, 256)] == ["cluster"] * 6
    wide = (1, 4, 12, 100, 255, 257, 264, 320, 500, 504, 505, 512)
    assert [gru_route(h) for h in wide] == ["wide"] * len(wide)
    grid = (513, 520, 1000, 1024, 1049, 1056, 1057, 1064, 1448, 1451, 1584, 1592, 2048,
            GRID_F32_MAX_HIDDEN)
    assert [gru_route(h) for h in grid] == ["grid"] * len(grid)
    assert [gru_route(h) for h in (GRID_F32_MAX_HIDDEN + 1, GRID_F32_MAX_HIDDEN + 8, 4096,
                                   GRID_MAX_HIDDEN)] == ["stepwise"] * 4
    with pytest.raises(ValueError, match="at least 1"):
        gru_route(0)


def test_gru_route_in_bf16():
    # bf16 keeps the cluster and persistent wide answers; above 512 (after
    # padding to a multiple of 8) it takes the grid form (gru_grid.cu) up
    # to GRID_MAX_HIDDEN, the widest width grid_plan finds blocks for on an
    # H100 (6336: 96 units a block; above GRID_RESIDENT_HIDDEN, 1440, with
    # part of W_hh streamed; above 5280, 80 units a block, the per-gate
    # plans), and the per-step form above it. f32 keeps its answers
    # (test_gru_route).
    bf16 = torch.bfloat16
    assert GRID_RESIDENT_HIDDEN == 1440 and GRID_MAX_HIDDEN == 6336
    assert [gru_route(h, bf16) for h in (8, 256, 12, 264, 512)] == ["cluster"] * 2 + ["wide"] * 3
    grid = (513, 520, 1000, 1024, 1056, 1064, 1401, 1440, 1441, 1448, 1451, 2048, 4096, 5280,
            5281, 5288, 5808, 5816, 6329, GRID_MAX_HIDDEN)
    assert [gru_route(h, bf16) for h in grid] == ["grid"] * len(grid)
    assert [gru_route(h, bf16) for h in (GRID_MAX_HIDDEN + 1, GRID_MAX_HIDDEN + 8, 8192)] == [
        "stepwise"] * 3
    assert [gru_route(h, torch.float32) for h in (520, 1024, 1448, 2048, 2120, GRID_MAX_HIDDEN)] == [
        "grid", "grid", "grid", "grid", "stepwise", "stepwise"]


@pytest.mark.parametrize("n,rows_at_1024", [(1, 16), (3, 16), (128, 64), (256, 128), (259, 144)])
def test_grid_plan_fits_an_h100_up_to_its_widest_width(n, rows_at_1024):
    # The grid form's plan at every padded width from 520 to
    # GRID_RESIDENT_HIDDEN: U of GRID_UNITS, R a multiple of 16 that covers
    # the batch in at most as many row tiles as the SMs hold, the whole W
    # slice beside the exchange within the 227 KB (232,448 bytes) a block
    # may use, and both directions' blocks (one a co-resident SM each)
    # within the 132 SMs.
    for h in range(520, GRID_RESIDENT_HIDDEN + 1, 8):
        units, rows, fwd, chain = grid_plan(n, h)
        assert units in GRID_UNITS and rows % 16 == 0 and rows >= 16, h
        assert rows - 16 < -(-n // -(-n // rows)), h  # no more than 15 rows of padding a tile
        assert grid_smem(h, units) <= H100_SMEM, h
        assert 2 * -(-h // units) * -(-n // rows) <= H100_SMS, h
        assert grid_plan(n, h - 7) == (units, rows, fwd, chain)  # the width padded to a multiple of 8
        assert fwd == GridSplit(-(-h // 16), 0, 0) and chain == GridSplit(-(-3 * h // 16), 0, 0), h
    # H=1024: 32 unit tiles, two row tiles where the batch needs them.
    assert grid_plan(n, 1024)[:2] == (32, rows_at_1024)
    assert grid_plan(n, GRID_RESIDENT_HIDDEN)[0] == 24
    assert grid_smem(GRID_RESIDENT_HIDDEN, 24) == 232320
    # Above: the least U, a multiple of 8, whose blocks fit the SMs, each
    # wgmma of the forward n <= 256 (one of 3U columns up to
    # GRID_GATE_UNITS, one a gate, n = U, above), each kernel's resident k16
    # steps (a whole number of chunks) beside its ring and exchange within
    # the 227 KB, and the streamed chunks covering the rest of the
    # contraction (zero past it), at every padded width up to
    # GRID_MAX_HIDDEN. The per-gate plans take passes of 128 rows in both
    # kernels at every batch (their warpgroups split the rows, so a pass
    # covers the units a block at once), the forward 4 ring stages or more
    # and the chain chunks of GRID_GATE_CHAIN_CHUNK k16 steps.
    for h in range(GRID_RESIDENT_HIDDEN + 8, GRID_MAX_HIDDEN + 1, 8):
        units, rows, *splits = plan = grid_plan(n, h)
        tiles = -(-h // units)
        gate = units > GRID_GATE_UNITS
        assert units % 8 == 0 and 24 <= units <= GRID_MAX_UNITS, h
        assert (units if gate else 3 * units) <= 256 and gate == (h > 5280), h
        assert 2 * tiles * -(-n // rows) <= H100_SMS, h
        assert units == 24 or 2 * -(-h // (units - 8)) > H100_SMS, h
        assert rows % 16 == 0 and rows - 16 < -(-n // -(-n // rows)), h
        for kind, split in zip(("fwd", "chain"), splits):
            k16 = -(-(h if kind == "fwd" else 3 * h) // 16)
            assert grid_kernel_smem(kind, units, split.resident, split.stages,
                                    split.pass_rows) <= H100_SMEM, h
            assert split.pass_rows == (128 if gate else 64) or (split.streamed and rows > 64), h
            if split.streamed:
                chunk = grid_chunk(kind, units)
                assert chunk == (4 if kind == "fwd" else GRID_GATE_CHAIN_CHUNK if gate else 8), h
                assert split.resident % chunk == 0 and split.streamed % chunk == 0, h
                assert split.resident + split.streamed - chunk < k16 <= split.resident + split.streamed, h
                # The per-gate forward parks its sums in 4 stages.
                assert (4 if gate and kind == "fwd" else 2) <= split.stages <= 8, h
            else:
                assert split == GridSplit(k16, 0, 0) and not gate, h
        # The forward's products cover the 3U columns, each wgmma n <= 256:
        # one of 3U, or one a gate of U (the chain's products, n = U, too).
        products, width = (3, units) if gate else (1, 3 * units)
        assert products * width == 3 * units and width <= 256, h
        assert grid_plan(n, h - 7) == plan, h
    assert [grid_plan(n, h)[0] for h in (1448, 2048, 4096, 5280, 5288, 5808, 5816,
                                         GRID_MAX_HIDDEN)] == [24, 32, 64, 80, 88, 88, 96, 96]
    for h in range(GRID_MAX_HIDDEN + 8, GRID_MAX_HIDDEN + 200, 8):
        assert grid_plan(n, h) is None, h
    # A card with fewer SMs or less shared memory gets a plan that fits it,
    # or none.
    assert grid_plan(n, 1024, sms=66)[:2] == (32, 16 * -(-n // 16))
    assert grid_plan(n, 1024, smem=200_000)[:2] == (24, 16 * -(-n // 16))
    assert grid_plan(n, 1024, sms=60) is None


@pytest.mark.parametrize("n,rows_at_1024", [(1, 16), (3, 16), (128, 128), (259, 272)])
def test_grid_f32_plan_fits_an_h100_up_to_its_widest_width(n, rows_at_1024):
    # The f32 grid form's plan at every padded width from 520 to
    # GRID_F32_RESIDENT_HIDDEN (1056): 16 units a block, R a multiple of 16
    # that covers the batch in at most as many row tiles as the SMs hold
    # for both directions' unit tiles (passes of 128 rows inside a block),
    # the whole f32 W_hh slice of either kernel beside the most ring stages
    # of 4 and 3 that fit in the 232,448 bytes a block may use. Above it the
    # streamed plans (test_grid_f32_streamed_plans_fit_an_h100), up to
    # GRID_F32_MAX_HIDDEN (2112); none above.
    for h in range(520, GRID_F32_RESIDENT_HIDDEN + 1, 8):
        plan = grid_f32_plan(n, h)
        units, rows, stages, fwd, chain = plan
        tiles = -(-h // units)
        assert units == GRID_F32_UNITS == 16 and rows % 16 == 0 and rows >= 16, h
        assert rows - 16 < -(-n // -(-n // rows)), h  # no more than 15 rows of padding a tile
        assert 2 * tiles * -(-n // rows) <= H100_SMS, h
        assert fwd == GridF32Split(-(-h // 16), 0, 0) and chain == GridF32Split(-(-3 * h // 16), 0, 0)
        smem = [grid_f32_smem(kind, h, stages) for kind in ("fwd", "chain")]
        assert max(smem) <= H100_SMEM and stages in (3, 4), h
        assert stages == 4 or max(grid_f32_smem(k, h, stages + 1) for k in ("fwd", "chain")) > H100_SMEM, h
        assert grid_f32_plan(n, h - 7) == plan, h  # the width padded to a multiple of 8
    # The forward's [48][round16(H)] f32 slice and the chain's [16][round16(3H)]
    # beside 8 KB a stage.
    assert GRID_F32_STAGE_BYTES == 8192
    assert grid_f32_smem("fwd", 1024, 4) == 4 * 48 * 1024 + 4 * 8192 == 229376
    assert grid_f32_smem("chain", 1000, 4) == 4 * 16 * 3008 + 4 * 8192
    assert grid_f32_plan(n, 1024)[:3] == (16, rows_at_1024, 4)
    assert grid_f32_plan(n, 1000).stages == 4 and grid_f32_plan(n, 520).stages == 4
    assert grid_f32_plan(n, 1040).stages == 4 and grid_f32_plan(n, 1048).stages == 3
    assert grid_f32_plan(n, GRID_F32_RESIDENT_HIDDEN)[:3] == (16, 16 * -(-n // 16), 3)
    # H=520: 33 unit tiles, two row tiles where the batch needs them.
    assert grid_f32_plan(n, 520).rows == (16 * -(-n // 16) if n <= 64 else 16 * -(-n // 32))
    assert [grid_f32_plan(n, h).units for h in (1064, 1448, 1584, 1592, 2048, GRID_F32_MAX_HIDDEN)
            ] == [24, 24, 24, 32, 32, 32]
    for h in (GRID_F32_MAX_HIDDEN + 1, GRID_F32_MAX_HIDDEN + 8, 4096):
        assert grid_f32_plan(n, h) is None, h
    # A card with fewer SMs or less shared memory gets a plan that fits it,
    # or none.
    assert grid_f32_plan(n, 1024, sms=127) is None
    assert grid_f32_plan(n, 1024, smem=222_000).stages == 3
    assert grid_f32_plan(n, 1024, smem=220_000) is None


# The f32 plans up to 1056 as the resident form defined them (all of W_hh
# resident): for each batch, runs of padded widths (first, last) with
# their (rows, A stages); 16 units a block throughout.
_F32_RESIDENT_PLANS = {
    1: [(520, 1040, (16, 4)), (1048, 1056, (16, 3))],
    3: [(520, 1040, (16, 4)), (1048, 1056, (16, 3))],
    128: [(520, 528, (64, 4)), (536, 1040, (128, 4)), (1048, 1056, (128, 3))],
    259: [(520, 528, (144, 4)), (536, 1040, (272, 4)), (1048, 1056, (272, 3))],
}


def test_wide_backward_phases_route():
    # gru_wide_bwd's coefficients and dW, in both dtypes: gru_bwd.cu's
    # mma.sync tiles up to MAX_WIDE_HIDDEN (the persistent form's widths,
    # padded), above it gru_bwd_wide.cu's wgmma kernels, f32 in 3xTF32 at
    # every width (none measured slower than gru_bwd.cu's: PERF.md).
    assert [bwd_phases(h) for h in (8, 256, 264, 504, 512)] == ["gru_bwd"] * 5
    wide = (520, 1024, 1064, 1448, 2048, 2112, 2120, 5288, 6336, 8192)
    assert [bwd_phases(h) for h in wide] == ["gru_bwd_wide"] * len(wide)


def test_f32_wgmma_phases_fit_an_h100_at_every_width():
    # gru_bwd_wide.cu's f32 kernels ask for the same ring whatever H is
    # (their tiles are 128 x 192, 16 of the contraction a stage): coef 6
    # stages of 32 KB (h_prev [128][16], W_hh^T hi and lo [192][16]), dw 5
    # of 40 KB (dpx and r [16][128], h_prev^T hi and lo), with their
    # mbarriers and 1 KB of alignment, within an H100 block's 227 KB at
    # every padded f32 width that runs them, up to 8192 (the card tests
    # hold the mirror against the kernels' own count).
    assert bwd_wide_f32_smem("coef") == 6 * 32768 + 6 * 16 + 1024 == 197728
    assert bwd_wide_f32_smem("dw") == 5 * 40960 + 5 * 16 + 1024 == 205904
    widths = [h for h in range(8, 8193, 8) if bwd_phases(h) == "gru_bwd_wide"]
    assert widths[0] == MAX_WIDE_HIDDEN + 8 and widths[-1] == 8192
    for h in widths:
        assert max(bwd_wide_f32_smem("coef"), bwd_wide_f32_smem("dw")) <= H100_SMEM, h


@pytest.mark.parametrize("h,tiles,rounds", [(1064, 312, 19), (1448, 560, 34), (2048, 1056, 64),
                                            (5288, 7000, 425)])
def test_f32_dw_splits_keep_the_ranges_short_and_fill_the_card(h, tiles, rounds):
    # The f32 dW on wgmma (the transposed product: rows j of dph, 128 a
    # tile, over dpx's first 2H columns and then its last H; columns k of
    # dW, 192 a tile) has 2 * ceil(H/192) * (ceil(2H/128) + ceil(H/128))
    # tiles a range of rows. f32 keeps gru_bwd.cu's ranges at every width,
    # one a 512 rows up to 8 (at T=257, N=128: 8 of 4112 rows), for the
    # accuracy of the tensor cores' truncating f32 sums; the 8 ranges' tiles
    # then fill the card's 132 SMs in whole rounds but for under 1% (1064:
    # 2496 tiles in 19 rounds; 1448: 4480 in 34; 2048: 8448, 64 whole
    # rounds; 5288: 56000 in 425).
    assert _dw_wide_tiles(h, False) == tiles
    assert _dw_splits(257, 128, h) == 8 == _dw_splits(257, 128, h, False)
    assert -(-8 * tiles // H100_SMS) == rounds and 8 * tiles / (rounds * H100_SMS) > 0.99
    # At most one range a 512 rows; the bf16 tiles' counts stay theirs.
    assert _dw_splits(2, 3, h) == 1 and _dw_splits(9, 259, h) == 4
    assert _dw_splits(257, 128, 1024, True) == 4 and _dw_splits(257, 128, 2048, True) == 1


def test_tf32x3_split_products_keep_f32_accuracy():
    # The 3xTF32 products of gru_bwd_wide.cu's f32 coef and dw (and of
    # gru_bwd.cu's): hi = the upper 19 bits of x, lo = those of x - hi,
    # a b as a_lo b_hi + a_hi b_lo + a_hi b_hi. Each part is a tf32 value;
    # |x - hi - lo| < 2**-20 |x|, so a product drops less than 3 * 2**-20
    # |a| |b|. Here in float64 (exact products) against the float64
    # product, and coef and dW/db built from those products against the f32
    # plain versions at H=520 within the card tests' tolerances (coef 1e-5
    # of its largest entry; dW, db 1e-4 of theirs + 1e-5).
    rng = np.random.default_rng(24)
    t, n, h = 2, 5, 520
    x = torch.from_numpy(rng.normal(size=4096).astype(np.float32))
    hi, lo = tf32_split(x)
    bits = torch.cat([hi, lo]).view(torch.int32) & 0x1FFF
    assert not bits.any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err < 2.0**-20 * x.double().abs()).all()
    px_f, px_b = (torch.from_numpy(rng.normal(size=(t, n, 3 * h)).astype(np.float32))
                  for _ in range(2))
    w = torch.from_numpy(((rng.random((2, h, 3 * h)) * 2 - 1) / h**0.5).astype(np.float32))
    b = torch.from_numpy(((rng.random((2, 3 * h)) * 2 - 1) / h**0.5).astype(np.float32))
    ys_f, ys_b = (torch.from_numpy((rng.random((t, n, h)) * 2 - 1).astype(np.float32))
                  for _ in range(2))
    dpx_f, dpx_b = (torch.from_numpy((rng.normal(size=(t, n, 3 * h)) * 0.1).astype(np.float32))
                    for _ in range(2))
    h_prev = torch.stack([torch.cat([torch.zeros_like(ys_f[:1]), ys_f[:-1]]),
                          torch.cat([ys_b[1:], torch.zeros_like(ys_b[:1])])]).reshape(2, t * n, h)
    ph = tf32x3_matmul_reference(h_prev, w)
    exact = h_prev.double() @ w.double()
    assert ((ph - exact).abs() <= 3 * 2.0**-20 * (h_prev.double().abs() @ w.double().abs())).all()
    # coef from the 3xTF32 ph (the gate math in f32, as the kernel's).
    ph = ph.float() + b[:, None, :]
    xr, xz, xn = torch.stack([px_f, px_b]).reshape(2, t * n, 3 * h).split(h, dim=-1)
    hr, hz, hn = ph.split(h, dim=-1)
    r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
    c = torch.tanh(xn + r * hn)
    coef = torch.stack([z, (1 - z) * (1 - c * c), (h_prev - c) * z * (1 - z), r,
                        hn * r * (1 - r)], dim=2)
    want = gru_bwd_coefficients_reference(px_f, px_b, ys_f, ys_b, w, b).reshape(coef.shape)
    torch.testing.assert_close(coef, want, rtol=0, atol=1e-5 * want.abs().max().item())
    dph = _dph(dpx_f, dpx_b, want).reshape(2, t * n, 3 * h)
    dw = tf32x3_matmul_reference(h_prev.transpose(1, 2), dph)
    exact = h_prev.double().transpose(1, 2) @ dph.double()
    assert ((dw - exact).abs() <= 3 * 2.0**-20 * (h_prev.double().abs().transpose(1, 2)
                                                  @ dph.double().abs())).all()
    dw_want, db_want = gru_bwd_dw_reference(ys_f, ys_b, dph.reshape(2, t, n, 3 * h))
    torch.testing.assert_close(dw.float(), dw_want, rtol=0,
                               atol=1e-4 * dw_want.abs().max().item() + 1e-5)
    torch.testing.assert_close(dph.sum(dim=1), db_want, rtol=0,
                               atol=1e-4 * db_want.abs().max().item() + 1e-5)


def test_f32_wgmma_phases_plain_versions_compose_to_the_pallas_vjp():
    # On CPU tensors gru_bwd_coef_wide_f32 and gru_bwd_dw_wide_f32 run their
    # plain versions; around the chain's they give the backward's dW and db
    # as gru_recurrence4's Pallas backward in interpret mode does (atol
    # 1e-5, as the phases' test), and the dph the dW phase rebuilds from
    # dpx and coef's r is the chain's own, bit for bit.
    t, h = 7, 16
    args = _case(t, seed=24)
    rng = np.random.default_rng(25)
    dys = [rng.normal(size=(t, 8, h)).astype(np.float32) for _ in range(2)]
    _, vjp = jax.vjp(lambda *a: gru_recurrence4(*a, jnp.float32, True), *map(jnp.asarray, args))
    want = vjp(tuple(map(jnp.asarray, dys)))
    px_f, px_b, w, b = map(torch.from_numpy, args)
    dy_f, dy_b = map(torch.from_numpy, dys)
    ys_f, ys_b = gru_recurrence_reference(px_f, px_b, w, b)
    coef = gru_bwd_coef_wide_f32(px_f, px_b, ys_f, ys_b, w, b)
    assert coef.shape == (2, t * 8, 5, h)
    dpx_f, dpx_b, dph = gru_bwd_chain_reference(coef.reshape(2, t, 8, 5, h), dy_f, dy_b, w)
    assert torch.equal(_dph(dpx_f, dpx_b, coef), dph)
    dw, db = gru_bwd_dw_wide_f32(ys_f, ys_b, dpx_f, dpx_b, coef)
    for name, g, j in zip(("dw_hh", "db_hh"), (dw, db), want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("n", [1, 3, 128, 259])
def test_grid_f32_streamed_plans_fit_an_h100(n):
    # Above GRID_F32_RESIDENT_HIDDEN, at every padded width up to
    # GRID_F32_MAX_HIDDEN: U the least of GRID_F32_STREAM_UNITS (24, 32)
    # whose unit tiles of both directions fit the 132 SMs, at most 132
    # blocks, R as the resident plans pick it, 4 A ring stages; each
    # kernel's resident k16 steps, its W ring (GRID_F32_RING_BYTES of whole
    # chunks of GRID_F32_CHUNK k16 steps: 4 or 5 stages) and its A rings
    # within the 232,448 bytes a block may use, with not one k16 step more
    # resident; the resident and streamed steps covering the contraction,
    # the streamed ones zero past it by less than a chunk.
    for h in range(GRID_F32_RESIDENT_HIDDEN + 8, GRID_F32_MAX_HIDDEN + 1, 8):
        plan = grid_f32_plan(n, h)
        units, rows, stages, *splits = plan
        tiles = -(-h // units)
        blocks = 2 * tiles * -(-n // rows)
        assert units in GRID_F32_STREAM_UNITS and blocks <= H100_SMS, h
        assert units == GRID_F32_STREAM_UNITS[0] or 2 * -(-h // (units - 8)) > H100_SMS, h
        assert rows % 16 == 0 and rows - 16 < -(-n // -(-n // rows)) and stages == 4, h
        for kind, split in zip(("fwd", "chain"), splits):
            k16 = -(-(h if kind == "fwd" else 3 * h) // 16)
            chunk = GRID_F32_CHUNK[kind]
            assert grid_f32_kernel_smem(kind, units, split.resident, split.stages, stages) <= H100_SMEM
            assert grid_f32_kernel_smem(kind, units, split.resident + 1, split.stages,
                                        stages) > H100_SMEM, h
            chunk_bytes = 4 * 16 * chunk * (3 * units if kind == "fwd" else units)
            assert split.stages == 49152 // chunk_bytes in (4, 5) and split.streamed % chunk == 0, h
            assert split.resident + split.streamed - chunk < k16 <= split.resident + split.streamed
            nc = split.streamed // chunk
            assert grid_f32_stream_elems(kind, h, plan) == 2 * tiles * nc * chunk_bytes // 4
        assert grid_f32_plan(n, h - 7) == plan, h
    # The plans of the widths the smoke times: 24 units at 1064 (90 blocks)
    # and 1448 (122), 32 at 2048 (128 blocks, 52 chunks a block and kernel
    # streamed each step).
    p1064, p2048 = grid_f32_plan(n, 1064), grid_f32_plan(n, 2048)
    assert p1064.fwd == GridF32Split(33, 34, 5) and p1064.chain == GridF32Split(99, 102, 5)
    assert p2048.fwd == GridF32Split(24, 104, 4) and p2048.chain == GridF32Split(73, 312, 4)
    # Every plan up to GRID_F32_RESIDENT_HIDDEN is as the resident form defined it.
    for first, last, (rows, stages) in _F32_RESIDENT_PLANS[n]:
        for h in range(first, last + 1, 8):
            plan = grid_f32_plan(n, h)
            assert plan[:3] == (16, rows, stages), h
            assert plan.fwd.streamed == plan.chain.streamed == 0, h


def test_jax_bf16_dw_at_few_rows_nears_the_bound_the_kernels_are_held_to():
    # The open check of the bf16 dW bound (1e-3 of the largest entry, the
    # card tests'): at T=2 and N=5 the second chain step's rows have h_prev
    # = 0, so a dW entry sums five products, and a rounding of dph that
    # flips between two float32 summation orders moves it by h_prev times
    # one bf16 step of dph. The JAX package's own bf16 dW (the Pallas
    # kernel in interpret mode), against the port's plain version on the
    # same saved ys, reaches 0.87 of the bound here (H=2048, seed 6) with
    # 0.14% of dpx on the other bf16 neighbour; at H=5280 it misses by 1.65x,
    # 511 entries past (tests/torch_fixtures/bf16_dw_reference_check.py,
    # too large for this suite: 8 GB). The port's CPU twin is the plain
    # version, bit for bit. The readings follow XLA's order of float32 sums
    # on this CPU, so the test holds only that no entry passes the bound
    # and that some dpx roundings flip.
    got = dw_check(2, 5, 2048, 6)
    assert got["twin_equals_plain"]
    assert got["jax_dw_entries_past_bound"] == 0, got
    assert got["jax_dpx_flipped_share"] > 0, got


@pytest.mark.parametrize("h", [1, 12, 100])
def test_zero_padded_recurrence_equals_the_unpadded_one(h):
    # The wide wrappers pad H to the next multiple of 8 (zero px, W_hh rows
    # and columns, b_hh): the padded units stay 0 and feed nothing, so the
    # padded recurrence, forward and backward, sliced back, is the
    # unpadded one. In float64, so that only a difference in the algebra
    # would show: atol 1e-12 (the padded products add exact zero terms).
    pad = -h % 8
    rng = np.random.default_rng(h)
    t, n = 6, 5
    px_f, px_b = (torch.from_numpy(rng.normal(size=(t, n, 3 * h))) for _ in range(2))
    w = torch.from_numpy(rng.normal(size=(2, h, 3 * h)) * 0.3)
    b = torch.from_numpy(rng.normal(size=(2, 3 * h)) * 0.1)
    dy_f, dy_b = (torch.from_numpy(rng.normal(size=(t, n, h))) for _ in range(2))
    padded = (_pad_gates(px_f, pad), _pad_gates(px_b, pad), _pad_w(w, pad), _pad_gates(b, pad))
    assert padded[2].shape == (2, h + pad, 3 * (h + pad))
    ys = gru_recurrence_reference(px_f, px_b, w, b)
    ys_p = gru_recurrence_reference(*padded)
    for a, b_ in zip(ys, ys_p):
        assert torch.equal(b_[..., h:], torch.zeros_like(b_[..., h:]))
        torch.testing.assert_close(b_[..., :h], a, rtol=0, atol=1e-12)
    want = gru_bwd_reference(px_f, px_b, *ys, dy_f, dy_b, w, b)
    dys_p = [torch.nn.functional.pad(d, (0, pad)) for d in (dy_f, dy_b)]
    got = gru_bwd_reference(*padded[:2], *ys_p, *dys_p, *padded[2:])
    got = (_unpad_gates(got[0], h), _unpad_gates(got[1], h), _unpad_gates(got[2][:, :h], h),
           _unpad_gates(got[3], h))
    for name, g, a in zip(("dpx_f", "dpx_b", "dw_hh", "db_hh"), got, want):
        assert g.shape == a.shape, name
        torch.testing.assert_close(g, a, rtol=0, atol=1e-12, msg=name)


@pytest.mark.parametrize("h", [12, 264, 320, 520, 1451])
def test_recurrence_matches_pallas_bf16_at_wide_widths(h):
    # bf16 compute (the Pallas kernel's default) at the wide route's
    # widths (520: the grid form's, gru_grid.cu, whose twins on the card
    # are these plain versions; 1451: its streamed plans', padded to 1456,
    # and gru_bwd_wide.cu's), against gru_recurrence4(..., jnp.bfloat16, True) in interpret
    # mode on the same bf16 inputs. Tolerances: ys 1e-2 and dpx 2e-2, as
    # tests/test_torch_bf16.py states them at H=32 (a rounding of h that
    # flips feeds the next steps); dW and db 1e-3 of their largest entry,
    # the bound the card's bf16 rows use (chip_smoke.py): at H=264 some of
    # dph's 125k bf16 roundings flip between the two sides' products, and a
    # flip moves a dW entry by one bf16 ulp of dph times h_prev (read here:
    # 1.7e-3 against a largest entry of 3.0, 5.8e-4 of it; H=32 stays
    # within 1e-4).
    t = 5
    px_f, px_b, w, b = _case(t, n=5, h=h, seed=h)
    rng = np.random.default_rng(h + 1)
    dys = [rng.normal(size=(t, 5, h)).astype(np.float32) for _ in range(2)]
    pxs = [jnp.asarray(p, jnp.bfloat16) for p in (px_f, px_b)]
    ys_j, vjp = jax.vjp(lambda pf, pb, ww, bb: gru_recurrence4(pf, pb, ww, bb, jnp.bfloat16, True),
                        *pxs, jnp.asarray(w), jnp.asarray(b))
    grads_j = vjp(tuple(jnp.asarray(d, jnp.bfloat16) for d in dys))

    def port(x):  # a bf16 JAX array as the same bf16 tensor
        return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)

    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    ys = gru_recurrence(port(pxs[0]), port(pxs[1]), wt, bt)
    for got, want in zip(ys, ys_j):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                                   atol=1e-2)
    got = gru_bwd_reference(port(pxs[0]), port(pxs[1]), *ys,
                            *(port(jnp.asarray(d, jnp.bfloat16)) for d in dys), wt, bt)
    for i, (g, j) in enumerate(zip(got, grads_j)):
        j = np.asarray(j, np.float32)
        atol = 2e-2 if i < 2 else 1e-3 * np.abs(j).max()
        np.testing.assert_allclose(g.float().numpy(), j, rtol=0, atol=atol)


@pytest.mark.parametrize("hidden", [100, 512])
def test_recognition_weights_load_strictly_at_other_gru_widths(hidden):
    # recognition_state_dict_from_jax (and bigru_state_dict_from_jax in it)
    # maps a JAX model of any gru_hidden into RecognitionModel(gru_hidden=
    # ...) with a strict load, every tensor equal.
    variables = random_variables(JaxRecognition(n_classes=97, gru_hidden=hidden), (1, 64, 64, 1),
                                 hidden)
    sd = recognition_state_dict_from_jax(variables)
    model = RecognitionModel(n_classes=97, gru_hidden=hidden)
    model.load_state_dict(sd, strict=True)
    assert model.gru.hidden == hidden
    assert tuple(model.gru.weight_hh_l1_reverse.shape) == (3 * hidden, hidden)
    for key, value in model.state_dict().items():
        assert torch.equal(value, sd[key]), key
