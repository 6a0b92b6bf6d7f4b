"""Port's CTC loss (plain alpha and beta recursions on CPU, the twins of
``csrc/ctc_alpha.cu`` and ``csrc/ctc_beta.cu``) vs the JAX package's
``ctc_loss_forward`` on both of its backends (Pallas in interpret mode and
``lax.scan``) and torch's ``F.ctc_loss``, values and gradients with respect
to the log-probs, on the same numpy inputs; and each plain recursion
against its Pallas kernel on the same operands.

Tolerances: NLL values rtol 1e-5 / atol 1e-5 (float32 log-space sums over
at most 20 steps, as ``tests/test_pallas_ctc.py`` uses); gradients rtol
1e-4 / atol 1e-5 against JAX (the same), atol 1e-5 against ``F.ctc_loss``
(its own formulation of the same gradient, taken through a log_softmax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ocrs_models_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from ocrs_models_tpu.ops.ctc import ctc_loss_forward as jax_ctc_loss_forward
from ocrs_models_tpu.ops.pallas.ctc_kernel import _alpha_call as jax_alpha_call
from ocrs_models_tpu.ops.pallas.ctc_kernel import ctc_alpha_final as jax_ctc_alpha_final
from ocrs_models_torch.ops import (
    ctc_alpha_reference,
    ctc_beta_reference,
    ctc_loss,
    ctc_loss_forward,
)
from ocrs_models_torch.ops.ctc import NEG_INF, CTCAlphaFunction


def _case(seed, n=4, t=20, c=12, l=6):
    """The cases of ``tests/test_pallas_ctc.py``: ragged input and label
    lengths, empty labels allowed."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, t, c)).astype(np.float32)
    log_probs = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    label_lengths = rng.integers(0, l + 1, n).astype(np.int32)
    labels = np.zeros((n, l), np.int32)
    for i, ll in enumerate(label_lengths):
        labels[i, :ll] = rng.integers(1, c, ll)
    input_lengths = rng.integers(max(2 * l + 1, 4), t + 1, n).astype(np.int32)
    return log_probs, labels, input_lengths, label_lengths


def _tight_case():
    """Repeated labels (the can_skip gate) and an input length equal to the
    shortest feasible path."""
    lp = np.random.default_rng(7).standard_normal((2, 9, 5)).astype(np.float32)
    log_probs = np.asarray(jax.nn.log_softmax(jnp.asarray(lp), -1))
    labels = np.asarray([[1, 1, 2, 2], [3, 3, 3, 3]], np.int32)
    return log_probs, labels, np.asarray([9, 8], np.int32), np.asarray([4, 4], np.int32)


def _port_nll_and_grad(log_probs, labels, input_lengths, label_lengths):
    lp = torch.from_numpy(log_probs.copy()).requires_grad_(True)
    args = [torch.from_numpy(a) for a in (labels, input_lengths, label_lengths)]
    nll = ctc_loss_forward(lp, *args)
    ctc_loss(lp, *args).backward()
    return nll.detach().numpy(), lp.grad.numpy()


CASES = [pytest.param(lambda s=s: _case(s), id=f"ragged-{s}") for s in (0, 1, 2, 3)] + [
    pytest.param(_tight_case, id="repeated-tight")
]


@pytest.mark.parametrize("make", CASES)
@pytest.mark.parametrize("backend", ["pallas-interpret", "scan"])
def test_matches_jax(make, backend):
    args = make()
    nll, grad = _port_nll_and_grad(*args)
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(jax_ctc_loss_forward(*jargs, backend=backend))
    want_grad = np.asarray(jax.grad(lambda lp: jax_ctc_loss(lp, *jargs[1:], backend=backend))(jargs[0]))
    np.testing.assert_allclose(nll, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad, want_grad, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("make", CASES)
def test_matches_torch_ctc_loss(make):
    # F.ctc_loss's backward assumes log-softmax inputs and returns the
    # gradient of the logits, so both are differentiated through a
    # log_softmax (idempotent on these inputs).
    log_probs, labels, input_lengths, label_lengths = make()
    args = [torch.from_numpy(a).long() for a in (labels, input_lengths, label_lengths)]

    def nll_and_grad(loss_fn):
        x = torch.from_numpy(log_probs.copy()).requires_grad_(True)
        nll, loss = loss_fn(torch.log_softmax(x, -1))
        loss.backward()
        return nll.detach().numpy(), x.grad.numpy()

    got = nll_and_grad(lambda lp: (ctc_loss_forward(lp, *args), ctc_loss(lp, *args)))
    want = nll_and_grad(lambda lp: (
        F.ctc_loss(lp.transpose(0, 1), *args, reduction="none"),
        F.ctc_loss(lp.transpose(0, 1), *args, reduction="mean"),
    ))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)


def test_zero_weight_infeasible_row_gives_zero_gradient():
    # Row 1's labels need 2*4 - 1 = 7 steps (three repeats need blanks)
    # but it has 5: its NLL is the finite 1e30, and weighted by 0 it must
    # leave no trace (no NaN from 0 * inf) in the loss or the gradient.
    log_probs, labels, _, label_lengths = _tight_case()
    input_lengths = np.asarray([9, 5], np.int32)
    weight = torch.tensor([1.0, 0.0])
    lp = torch.from_numpy(log_probs.copy()).requires_grad_(True)
    nll = ctc_loss_forward(lp, torch.from_numpy(labels), torch.from_numpy(input_lengths),
                           torch.from_numpy(label_lengths))
    assert nll[1].item() == pytest.approx(-NEG_INF)
    loss = (nll / 4.0 * weight).sum()
    loss.backward()
    assert np.isfinite(loss.item())
    assert np.isfinite(lp.grad.numpy()).all()
    assert (lp.grad[1] == 0).all()
    jargs = [jnp.asarray(a) for a in (log_probs, labels, input_lengths, label_lengths)]
    jw = jnp.asarray([1.0, 0.0])
    want = jax.grad(lambda x: jnp.sum(
        jax_ctc_loss_forward(x, *jargs[1:], backend="pallas-interpret") / 4.0 * jw))(jargs[0])
    np.testing.assert_allclose(lp.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 5])
def test_beta_recursion_matches_autograd_of_alpha_scan(seed):
    # The backward of CTCAlphaFunction (the plain beta recursion) against
    # autograd through the plain alpha scan, for a random cotangent of one
    # sign per sample.
    log_probs, labels, input_lengths, _ = _case(seed)
    rng = np.random.default_rng(seed)
    n, t, _ = log_probs.shape
    s = 2 * labels.shape[1] + 1
    emit = torch.from_numpy(rng.normal(-2.0, 1.0, (n, t, s)).astype(np.float32))
    skip = torch.from_numpy(np.where(rng.random((n, s)) < 0.5, 0.0, NEG_INF).astype(np.float32))
    alpha0 = torch.full((n, s), NEG_INF)
    alpha0[:, :2] = torch.from_numpy(rng.normal(-1.0, 0.5, (n, 2)).astype(np.float32))
    lengths = torch.from_numpy(input_lengths)
    d_last = torch.from_numpy(-rng.random((n, s)).astype(np.float32))
    d_last[:, ::3] = 0.0

    def grads(fn):
        e = emit.clone().requires_grad_(True)
        a0 = alpha0.clone().requires_grad_(True)
        fn(e, a0).backward(d_last)
        return e.grad, a0.grad

    got = grads(lambda e, a0: CTCAlphaFunction.apply(e, skip, a0, lengths))
    want = grads(lambda e, a0: ctc_alpha_reference(e, skip, a0, lengths, final_only=True))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_eval_path_matches_training_path():
    # Without a gradient the alpha recursion keeps only its final state.
    args = [torch.from_numpy(a) for a in _case(4)]
    with torch.no_grad():
        eval_nll = ctc_loss_forward(*args)
    train_nll = ctc_loss_forward(args[0].clone().requires_grad_(True), *args[1:])
    torch.testing.assert_close(eval_nll, train_nll.detach(), rtol=0, atol=0)


# The edges the CUDA beta kernel's design makes dangerous, pinned on its
# plain version: S at the lane and warp boundaries (1, 31, 33, 65), and
# input lengths 1, 2 and T, so that every sample is frozen from another step.
FROZEN_LENGTHS = np.asarray([1, 2, 9, 3, 8, 5], np.int32)


@pytest.mark.parametrize("s", [1, 31, 33, 65])
def test_beta_reference_matches_pallas_vjp_at_lane_boundaries(s):
    # ctc_beta_reference against the VJP of the JAX package's
    # ctc_alpha_final (Pallas alpha and beta kernels in interpret mode) on
    # the same recursion operands. The JAX cotangent is that of its gated
    # emissions (zeroed at frozen steps, where the port's is 0): it is
    # compared at the active steps. rtol 1e-4 / atol 1e-6 as the test of the
    # plain beta recursion against autograd above.
    rng = np.random.default_rng(s)
    n, t = len(FROZEN_LENGTHS), 9
    emit = rng.normal(-2.0, 1.0, (n, t, s)).astype(np.float32)
    skip = np.where(rng.random((n, s)) < 0.5, 0.0, NEG_INF).astype(np.float32)
    alpha0 = np.full((n, s), NEG_INF, np.float32)
    alpha0[:, :2] = rng.normal(-1.0, 0.5, (n, min(2, s)))
    active = np.arange(t)[None, :] < FROZEN_LENGTHS[:, None]  # [N, T]

    emit_t, skip_t, alpha0_t = (torch.from_numpy(a) for a in (emit, skip, alpha0))
    lens_t = torch.from_numpy(FROZEN_LENGTHS)
    alphas = ctc_alpha_reference(emit_t, skip_t, alpha0_t, lens_t)
    # A cotangent only where the final state can be reached, as a reduction
    # of log-likelihoods gives it (the JAX gate is additive: on a state of
    # NEG_INF a seed of log|d| + 1e30 would leak through its frozen steps).
    d_last = -rng.random((n, s)).astype(np.float32)
    d_last[:, 2::3] = 0.0
    d_last[3] = 0.0  # a sample with no cotangent at all
    d_last[alphas[:, -1].numpy() < NEG_INF / 2] = 0.0
    d_t = torch.from_numpy(d_last)
    mag = d_t.abs()
    seed = torch.where(mag > 0, torch.log(mag) - alphas[:, -1], torch.full_like(mag, NEG_INF))
    sign = torch.where(d_t < 0, -1.0, 1.0).amin(dim=1)
    demit, dalpha0 = ctc_beta_reference(emit_t, skip_t, alphas, seed, sign, lens_t)

    act_j = jnp.asarray(active.T[:, :, None])  # [T, N, 1]
    emit_g = jnp.where(act_j, jnp.asarray(emit.transpose(1, 0, 2)), 0.0)
    gate = jnp.where(act_j, 0.0, NEG_INF) * jnp.ones((1, 1, s))
    final, vjp = jax.vjp(lambda e, a0: jax_ctc_alpha_final(e, gate, jnp.asarray(skip), a0, True),
                         emit_g, jnp.asarray(alpha0))
    want_demit, want_dalpha0 = vjp(jnp.asarray(d_last))
    want_demit = np.asarray(want_demit).transpose(1, 0, 2) * active[:, :, None]

    np.testing.assert_allclose(alphas[:, -1].numpy(), np.asarray(final), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(demit.numpy(), want_demit, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dalpha0.numpy(), np.asarray(want_dalpha0), rtol=1e-4, atol=1e-6)
    assert (demit.numpy()[~active] == 0).all() and (demit[:, 0] == 0).all()
    assert (demit[3] == 0).all() and (dalpha0[3] == 0).all()


@pytest.mark.parametrize("s", [1, 31, 33, 65])
def test_alpha_reference_states_match_pallas_alpha_call_with_frozen_rows(s):
    # Every state of ctc_alpha_reference against the JAX package's Pallas
    # alpha kernel (interpret mode) on the same operands, gated as
    # ctc_loss_forward gates them, at input lengths 0, 1, 2, T and T + 3.
    # Rows at and past a sample's last active step hold that step's state:
    # the rows the CUDA kernel fills after its loop. A length of 0 acts as
    # 1. rtol 1e-5 / atol 1e-5 as the NLL values of test_matches_jax.
    rng = np.random.default_rng(s + 100)
    t = 9
    lengths = np.asarray([0, 1, 2, t, t + 3], np.int32)
    n = len(lengths)
    emit = rng.normal(-2.0, 1.0, (n, t, s)).astype(np.float32)
    skip = np.where(rng.random((n, s)) < 0.5, 0.0, NEG_INF).astype(np.float32)
    alpha0 = np.full((n, s), NEG_INF, np.float32)
    alpha0[:, :2] = rng.normal(-1.0, 0.5, (n, min(2, s)))
    alphas = ctc_alpha_reference(*(torch.from_numpy(a) for a in (emit, skip, alpha0, lengths)))
    alphas = alphas.numpy()

    active = np.arange(t)[None, :] < lengths[:, None]  # [N, T]
    act_j = jnp.asarray(active.T[:, :, None])  # [T, N, 1]
    emit_g = jnp.where(act_j, jnp.asarray(emit.transpose(1, 0, 2)), 0.0)
    gate = jnp.where(act_j, 0.0, NEG_INF) * jnp.ones((1, 1, s))
    want = jax_alpha_call(emit_g, gate, jnp.asarray(skip), jnp.asarray(alpha0), interpret=True)
    want = np.asarray(want).transpose(1, 0, 2)

    assert alphas.shape == want.shape == (n, t, s)
    np.testing.assert_allclose(alphas, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(alphas[:, 0], alpha0)
    for i, length in enumerate(lengths):
        last = min(max(int(length), 1), t) - 1
        assert (alphas[i, last:] == alphas[i, last]).all()
        np.testing.assert_allclose(want[i, last:], np.broadcast_to(want[i, last], (t - last, s)),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_labels", [15, 16, 32], ids=["S31", "S33", "S65"])
@pytest.mark.parametrize("backend", ["pallas-interpret", "scan"])
def test_loss_gradient_matches_jax_with_every_sample_frozen_elsewhere(n_labels, backend):
    # The whole loss and its gradient through the plain alpha and beta
    # recursions against the JAX package, label arrays 15, 16 and 32 wide
    # (S = 31, 33, 65), input lengths 1, 2, T and between. Labels without
    # neighbouring repeats, short enough to fit: every row is feasible.
    # Tolerances as test_matches_jax.
    t, c = 40, 12
    rng = np.random.default_rng(n_labels)
    input_lengths = np.asarray([1, 2, t, t // 2, t - 1], np.int32)
    label_lengths = np.asarray([1, 1, n_labels, min(n_labels, t // 4), n_labels], np.int32)
    n = len(input_lengths)
    logits = rng.standard_normal((n, t, c)).astype(np.float32)
    log_probs = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    labels = np.zeros((n, n_labels), np.int32)
    for i, ll in enumerate(label_lengths):
        labels[i, :ll] = (np.arange(ll) + i) % (c - 1) + 1
    args = (log_probs, labels, input_lengths, label_lengths)
    nll, grad = _port_nll_and_grad(*args)
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(jax_ctc_loss_forward(*jargs, backend=backend))
    want_grad = np.asarray(jax.grad(lambda lp: jax_ctc_loss(lp, *jargs[1:], backend=backend))(jargs[0]))
    assert (nll < 1e29).all()
    np.testing.assert_allclose(nll, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad, want_grad, rtol=1e-4, atol=1e-5)
    for i, length in enumerate(input_lengths):
        assert (grad[i, length:] == 0).all()


def _long_label_case(label_width, long_len, seed):
    """N=4, T=10 over 12 classes, labels ``label_width`` wide (S = 2 *
    label_width + 1): three rows short enough to fit, one of ``long_len``
    labels, which 10 steps cannot hold (its NLL is 1e30), as a line of text
    that long makes a batch of the training step. (T is short: the Pallas
    kernels in interpret mode compile a step at a time.)"""
    rng = np.random.default_rng(seed)
    n, t, c = 4, 10, 12
    logits = rng.standard_normal((n, t, c)).astype(np.float32)
    log_probs = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    label_lengths = np.asarray([3, 4, 1, long_len], np.int32)
    labels = np.zeros((n, label_width), np.int32)
    for i, ll in enumerate(label_lengths):
        labels[i, :ll] = rng.integers(1, c, ll)
    input_lengths = np.asarray([10, 9, 5, 10], np.int32)
    return log_probs, labels, input_lengths, label_lengths


@pytest.mark.parametrize("label_width,long_len", [(512, 449), (1024, 960)], ids=["S1025", "S2049"])
@pytest.mark.parametrize("backend", ["pallas-interpret", "scan"])
def test_long_labels_match_jax(label_width, long_len, backend):
    # Past S = 1024 (the CUDA kernels' several positions a thread): the
    # NLL of every row, the infeasible one's 1e30 included, and the
    # gradient of the loss with that row weighted 0, as the training step
    # weights a crop that cannot hold its label, against the JAX package.
    # Tolerances as test_matches_jax.
    args = _long_label_case(label_width, long_len, label_width)
    weight = np.asarray([1.0, 1.0, 1.0, 0.0], np.float32)
    lp = torch.from_numpy(args[0].copy()).requires_grad_(True)
    nll = ctc_loss_forward(lp, *(torch.from_numpy(a) for a in args[1:]))
    (nll / torch.from_numpy(args[3]).clamp(min=1) * torch.from_numpy(weight)).sum().backward()
    jargs = [jnp.asarray(a) for a in args]

    def weighted(x):
        per_row = jax_ctc_loss_forward(x, *jargs[1:], backend=backend)
        return jnp.sum(per_row / jnp.maximum(jargs[3], 1) * jnp.asarray(weight)), per_row

    # Jitted: run op by op, the Pallas kernels in interpret mode and the
    # scan take several times as long.
    (_, want), want_grad = jax.jit(jax.value_and_grad(weighted, has_aux=True))(jargs[0])
    assert nll[3].item() == pytest.approx(-NEG_INF) and (nll[:3] < 1e29).all()
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lp.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-5)
    assert (lp.grad[3] == 0).all()


def test_zero_weight_infeasible_row_gives_zero_gradient_past_1024_positions():
    # As test_zero_weight_infeasible_row_gives_zero_gradient, at S = 1025:
    # the 449-label row's NLL is the finite 1e30, and weighted by 0 it
    # leaves no trace in the loss or the gradient.
    log_probs, labels, input_lengths, label_lengths = _long_label_case(512, 449, 7)
    lp = torch.from_numpy(log_probs.copy()).requires_grad_(True)
    lengths = torch.from_numpy(label_lengths)
    nll = ctc_loss_forward(lp, torch.from_numpy(labels), torch.from_numpy(input_lengths), lengths)
    assert labels.shape[1] * 2 + 1 == 1025 and nll[3].item() == pytest.approx(-NEG_INF)
    loss = (nll / lengths.clamp(min=1) * torch.tensor([1.0, 1.0, 1.0, 0.0])).sum()
    loss.backward()
    assert np.isfinite(loss.item()) and np.isfinite(lp.grad.numpy()).all()
    assert (lp.grad[3] == 0).all() and (lp.grad[:3] != 0).any()
