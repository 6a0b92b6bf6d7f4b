"""Port's CTC loss (plain alpha and beta recursions on CPU, the twins of
``csrc/ctc_alpha.cu`` and ``csrc/ctc_beta.cu``) vs the JAX package's
``ctc_loss_forward`` on both of its backends (Pallas in interpret mode and
``lax.scan``) and torch's ``F.ctc_loss``, values and gradients with respect
to the log-probs, on the same numpy inputs.

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
from ocrs_models_torch.ops import ctc_alpha_reference, ctc_loss, ctc_loss_forward
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
