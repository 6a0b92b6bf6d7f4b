"""CTC loss with hand-written CUDA alpha and beta recursions.

Counterpart of ``ocrs_models_tpu/ops/ctc.py`` and of its Pallas kernels
``ctc_kernel._alpha_call`` / ``_beta_call``. Same contract: log-probs
``[N, T, C]`` (class 0 the blank), 0-padded labels ``[N, L]``, the extended
label sequence ``blank, l1, blank, ..., lL, blank`` of ``S = 2L + 1``
positions, per-sample NLL out; :func:`ctc_loss` divides it by
``max(len, 1)`` and takes the batch mean (torch's ``mean`` reduction).

The emission gather ``[N, T, C] -> [N, T, S]`` is ``torch.gather`` (its
backward is autograd's scatter); only the recursion over time is a kernel.
:class:`CTCAlphaFunction` wraps it: the forward runs :func:`ctc_alpha`
(``csrc/ctc_alpha.cu``), the backward :func:`ctc_beta`
(``csrc/ctc_beta.cu``), the reverse weighted-beta recursion of the JAX
package's ``_vjp_bwd``. On CPU tensors both wrappers run their plain
versions (:func:`ctc_alpha_reference`, :func:`ctc_beta_reference`, loops of
torch ops over time). Steps at or past a sample's input length are frozen
(``alpha[t] = alpha[t-1]``); the kernels compare ``t`` with the length
instead of reading the Pallas design's ``[T, N, S]`` additive gate, and
skip the frozen steps: each runs only a sample's active steps and fills
the frozen rows from its last state. Both kernels share one design (one
block per sample, one warp with shuffles where ``S <= 32``; each thread
copies its inputs a few steps ahead into a ring in shared memory, so no
step waits for device memory). A block holds at most 1024 threads, so
above ``S = 1024`` each thread owns ``2 ceil(S / 2048)`` positions and the
state lives in shared memory beside the ring while both fit (some 8 k
positions for alpha, 5 k for beta on an H100), past that in device memory
(:func:`ctc_design` names the one a call takes). The kernels take any ``S`` the Pallas kernels take, up to the
32-bit offsets' ``T * S < 2^31``, which the wrappers check. Each kernel has
a probe that times its chain of dependent steps alone
(:func:`ctc_alpha_chain_probe`, :func:`ctc_beta_chain_probe`).

Log space uses ``NEG_INF = -1e30``, not ``-inf``, with the JAX package's
``_lse3`` guard: a zero-weight row whose labels cannot fit its input then
gives a finite NLL of 1e30 and a zero gradient instead of ``0 * inf``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = torch.maximum(m, m.new_tensor(NEG_INF))
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe) + torch.exp(c - m_safe))
    return torch.where(m <= NEG_INF, torch.full_like(out, NEG_INF), out)


MAX_STATES = 2**31 - 1
"""The kernels' limit on ``T * S``: offsets within a sample are 32-bit."""

DESIGNS = ("per_position", "ring", "global")
"""Where a kernel keeps a sample's state (``csrc/ctc_step.cuh``), by the
code of its ``ocrs_ctc_*_design`` entry."""


def _check(name: str, emit: torch.Tensor, tensors: dict, input_lengths: torch.Tensor) -> None:
    n, t_len, s = emit.shape
    for key, (t, shape) in {"emit": (emit, (n, t_len, s)), **tensors}.items():
        if t.device != emit.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous float32 on {emit.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} shape {tuple(t.shape)} != {shape}")
    if input_lengths.dtype != torch.int32 or input_lengths.shape != (n,) or \
            input_lengths.device != emit.device:
        raise ValueError(f"{name}: input_lengths must be int32 [{n}] on {emit.device}")


# ------------------------------------------------------------------ alpha


def ctc_alpha_reference(emit, skip, alpha0, input_lengths, final_only=False):
    """Plain version of the forward recursion.

    :param emit: ``[N, T, S]`` emission log-probs of the extended labels
        (step 0 is unused: ``alpha0`` holds it).
    :param skip: ``[N, S]`` additive: 0 where the ``p-2 -> p`` transition
        is allowed, ``NEG_INF`` elsewhere.
    :param alpha0: ``[N, S]`` state at step 0.
    :param input_lengths: ``[N]`` int; steps ``t >= length`` are frozen.
    :return: all states ``[N, T, S]``, or ``alpha[T-1]`` ``[N, S]`` when
        ``final_only``.
    """
    n, t_len, s = emit.shape
    pad = alpha0.new_full((n, 2), NEG_INF)
    alpha, states = alpha0, [alpha0]
    for t in range(1, t_len):
        prev = torch.cat([pad, alpha], dim=1)
        new = _lse3(alpha, prev[:, 1 : s + 1], prev[:, :s] + skip) + emit[:, t]
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
        if not final_only:
            states.append(alpha)
    return alpha if final_only else torch.stack(states, dim=1)


def _alpha_lib() -> ctypes.CDLL:
    lib = _build.load("ctc_alpha")
    fn = lib.ocrs_ctc_alpha
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.ocrs_ctc_alpha_probe.argtypes = [i, i, i, p, p]
        lib.ocrs_ctc_alpha_probe.restype = ctypes.c_int
        lib.ocrs_ctc_alpha_design.argtypes = [i, i]
        lib.ocrs_ctc_alpha_design.restype = ctypes.c_int
    return lib


def _check_size(name: str, t_len: int, s: int) -> None:
    if t_len * s > MAX_STATES:
        raise ValueError(f"{name}: T * S = {t_len} * {s} is past the kernel's 32-bit offsets "
                         f"(at most {MAX_STATES})")


def wide_slots(s: int) -> list[range]:
    """The positions each thread of a block holds in turn above ``s =
    1024`` (``wide_shape`` in ``csrc/ctc_step.cuh``): slot ``i`` is
    position ``p + i P`` of every thread ``p < P``, ``2 ceil(s / 2048)``
    slots, ``P`` the fewest whole warps that hold ``s`` in that many."""
    k = 2 * ((s + 2047) // 2048)
    width = ((s + k - 1) // k + 31) // 32 * 32
    return [range(i * width, min((i + 1) * width, s)) for i in range(k)]


def ctc_design(kernel: str, s: int, device: torch.device) -> str:
    """Where ``kernel`` (``"ctc_alpha"`` or ``"ctc_beta"``) keeps a sample's
    state at ``s`` positions on CUDA ``device``: ``"per_position"`` (one
    thread a position, ``s <= 1024``), ``"ring"`` (shared memory, with its
    inputs copied a few steps ahead) or ``"global"`` (device memory)."""
    if device.type != "cuda":
        raise RuntimeError(f"ctc_design: needs a CUDA device, got {device}")
    lib = _alpha_lib() if kernel == "ctc_alpha" else _beta_lib()
    code = getattr(lib, f"ocrs_{kernel}_design")(device.index, s)
    if code < 0:
        _build.check(lib, -code, f"{kernel}_design")
    return DESIGNS[code]


def ctc_alpha(emit, skip, alpha0, input_lengths, final_only=False):
    """Forward recursion, same contract as :func:`ctc_alpha_reference`
    (``input_lengths`` int32). A CUDA tensor goes through ``ctc_alpha.cu``
    (one launch, one block per sample, or one warp where ``S <= 32``; each
    sample runs only its active steps, with its emissions copied into
    shared memory a few steps ahead, and its frozen rows are filled from
    its last state; above ``S = 1024`` a thread owns several positions,
    see :func:`ctc_design`); a CPU tensor through the plain version.
    ``T * S`` past :data:`MAX_STATES` raises ``ValueError`` on the card."""
    if emit.device.type == "cpu":
        return ctc_alpha_reference(emit, skip, alpha0, input_lengths, final_only)
    if not emit.is_cuda:
        raise RuntimeError(f"ctc_alpha: unsupported device {emit.device}")
    n, t_len, s = emit.shape
    _check_size("ctc_alpha", t_len, s)
    _check("ctc_alpha", emit, {"skip": (skip, (n, s)), "alpha0": (alpha0, (n, s))}, input_lengths)
    # With the state in device memory the kernel keeps it in the output's
    # rows, so it stores them all, and final_only keeps the last.
    keep_rows = final_only and s > 1024 and ctc_design("ctc_alpha", s, emit.device) == "global"
    one_row = final_only and not keep_rows
    out = torch.empty((n, 1 if one_row else t_len, s), device=emit.device, dtype=torch.float32)
    lib = _alpha_lib()
    p = _build.ptr
    rc = lib.ocrs_ctc_alpha(
        emit.device.index, p(emit), p(skip), p(alpha0), p(input_lengths), p(out),
        n, t_len, s, int(one_row), _build.stream_ptr(emit.device),
    )
    _build.check(lib, rc, "ctc_alpha")
    ctc_alpha.launches += 1
    return out[:, -1] if final_only else out


ctc_alpha.launches = 0


def _chain_probe(lib: ctypes.CDLL, entry: str, what: str, t_len: int, s: int,
                 device: torch.device) -> dict:
    if device.type != "cuda":
        raise RuntimeError(f"{what}: needs a CUDA device, got {device}")
    out = torch.zeros(3, device=device, dtype=torch.int64)
    rc = getattr(lib, entry)(device.index, t_len, s, _build.ptr(out), _build.stream_ptr(device))
    _build.check(lib, rc, what)
    cycles, ns, _ = out.tolist()
    return {"steps": t_len - 1, "cycles": cycles, "ns": ns}


def ctc_alpha_chain_probe(t_len: int, s: int, device: torch.device) -> dict:
    """Time of :func:`ctc_alpha`'s dependent chain alone on ``device``: one
    sample's ``t_len - 1`` steps over ``s`` positions on made-up emissions,
    with no global access in the loop, read from the kernel's own clocks,
    in the design :func:`ctc_design` names for ``s`` (not ``"global"``).
    Not a launch of the forward kernel: it counts none.

    :return: ``steps``, ``cycles`` (``clock64``) and ``ns``
        (``%globaltimer``) of the whole chain.
    """
    return _chain_probe(_alpha_lib(), "ocrs_ctc_alpha_probe", "ctc_alpha_chain_probe",
                        t_len, s, device)


# ------------------------------------------------------------------- beta


def ctc_beta_reference(emit, skip, alphas, seed, sign, input_lengths):
    """Plain version of the reverse weighted-beta recursion (the JAX
    package's ``_beta_kernel`` and ``_vjp_bwd`` after it).

    ``B[T-1] = seed``; for ``t < T-1``, while step ``t+1`` is active,
    ``B[t, p] = lse(B[t+1, p] + e[t+1, p], B[t+1, p+1] + e[t+1, p+1],
    B[t+1, p+2] + e[t+1, p+2] + skip[p+2])``, else ``B[t] = B[t+1]``.

    :param seed: ``[N, S]``: ``log|d alpha[T-1]| - alpha[T-1]``, or
        ``NEG_INF`` where the cotangent is 0.
    :param sign: ``[N]``: the sign of each sample's cotangent (uniform
        within a sample).
    :return: ``(demit [N, T, S], dalpha0 [N, S])``: ``sign * exp(alpha[t]
        + B[t])`` at active steps ``1 <= t < length`` (0 elsewhere), and
        the same at step 0 for ``alpha0``.
    """
    n, t_len, s = emit.shape
    pad_b = seed.new_full((n, 2), NEG_INF)
    pad_e = emit.new_zeros((n, 2))
    skip2 = torch.cat([skip[:, 2:], seed.new_full((n, 2), NEG_INF)], dim=1)[:, :s]
    beta = seed
    demit = torch.zeros_like(emit)
    sign = sign[:, None]
    for t in range(t_len - 1, -1, -1):
        if t < t_len - 1:
            b = torch.cat([beta, pad_b], dim=1)
            e = torch.cat([emit[:, t + 1], pad_e], dim=1)
            new = _lse3(b[:, :s] + e[:, :s], b[:, 1 : s + 1] + e[:, 1 : s + 1],
                        b[:, 2:] + e[:, 2:] + skip2)
            beta = torch.where((t + 1 < input_lengths)[:, None], new, beta)
        g = sign * torch.exp(alphas[:, t] + beta)
        if t == 0:
            return demit, g
        demit[:, t] = torch.where((t < input_lengths)[:, None], g, torch.zeros_like(g))
    raise ValueError("ctc_beta_reference: T must be >= 1")


def _beta_lib() -> ctypes.CDLL:
    lib = _build.load("ctc_beta")
    fn = lib.ocrs_ctc_beta
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.ocrs_ctc_beta_probe.argtypes = [i, i, i, p, p]
        lib.ocrs_ctc_beta_probe.restype = ctypes.c_int
        lib.ocrs_ctc_beta_design.argtypes = [i, i]
        lib.ocrs_ctc_beta_design.restype = ctypes.c_int
    return lib


def ctc_beta(emit, skip, alphas, seed, sign, input_lengths):
    """Reverse recursion, same contract as :func:`ctc_beta_reference`.
    A CUDA tensor goes through ``ctc_beta.cu`` (one launch, one block per
    sample, or one warp where ``S <= 32``; the recursion starts at each
    sample's last active step and its inputs are copied into shared memory
    a few steps ahead; above ``S = 1024`` a thread owns several positions,
    see :func:`ctc_design`); a CPU tensor through the plain version.
    ``T * S`` past :data:`MAX_STATES` raises ``ValueError`` on the card."""
    if emit.device.type == "cpu":
        return ctc_beta_reference(emit, skip, alphas, seed, sign, input_lengths)
    if not emit.is_cuda:
        raise RuntimeError(f"ctc_beta: unsupported device {emit.device}")
    n, t_len, s = emit.shape
    _check_size("ctc_beta", t_len, s)
    _check("ctc_beta", emit, {
        "skip": (skip, (n, s)), "alphas": (alphas, (n, t_len, s)),
        "seed": (seed, (n, s)), "sign": (sign, (n,)),
    }, input_lengths)
    demit = torch.empty_like(emit)
    dalpha0 = torch.empty_like(seed)
    lib = _beta_lib()
    p = _build.ptr
    rc = lib.ocrs_ctc_beta(
        emit.device.index, p(emit), p(skip), p(alphas), p(seed), p(sign), p(input_lengths),
        p(demit), p(dalpha0), n, t_len, s, _build.stream_ptr(emit.device),
    )
    _build.check(lib, rc, "ctc_beta")
    ctc_beta.launches += 1
    return demit, dalpha0


ctc_beta.launches = 0


def ctc_beta_chain_probe(t_len: int, s: int, device: torch.device) -> dict:
    """Time of :func:`ctc_beta`'s dependent chain alone on ``device``: one
    sample's ``t_len - 1`` steps over ``s`` positions on made-up emissions,
    with no global access in the loop, read from the kernel's own clocks,
    in the design :func:`ctc_design` names for ``s`` (not ``"global"``).
    Not a launch of the gradient kernel: it counts none.

    :return: ``steps``, ``cycles`` (``clock64``) and ``ns``
        (``%globaltimer``) of the whole chain.
    """
    return _chain_probe(_beta_lib(), "ocrs_ctc_beta_probe", "ctc_beta_chain_probe",
                        t_len, s, device)


class CTCAlphaFunction(torch.autograd.Function):
    """``alpha[T-1]`` of the forward recursion, differentiable in ``emit``
    and ``alpha0`` (the counterpart of ``ctc_alpha_final``'s custom VJP)."""

    @staticmethod
    def forward(ctx, emit, skip, alpha0, input_lengths):
        alphas = ctc_alpha(emit, skip, alpha0, input_lengths)
        ctx.save_for_backward(emit, skip, alphas, input_lengths)
        return alphas[:, -1].contiguous()

    @staticmethod
    def backward(ctx, d_last):
        emit, skip, alphas, input_lengths = ctx.saved_tensors
        d_last = d_last.contiguous()
        mag = d_last.abs()
        seed = torch.where(
            mag > 0, torch.log(mag) - alphas[:, -1], torch.full_like(mag, NEG_INF)
        ).contiguous()
        # The cotangent of a log-likelihood reduction has one sign per
        # sample (non-positive for an NLL loss).
        sign = torch.where(d_last < 0, -1.0, 1.0).amin(dim=1).contiguous()
        demit, dalpha0 = ctc_beta(emit, skip, alphas, seed, sign, input_lengths)
        return demit, None, dalpha0, None


def ctc_operands(log_probs, labels, input_lengths, label_lengths):
    """What the recursions run on, from the loss's arguments (see
    :func:`ctc_loss_forward`): ``(emit [N, T, S], skip [N, S], alpha0
    [N, S], input_lengths [N] int32)`` over the extended label sequence of
    ``S = 2L + 1`` positions, all on the device of ``log_probs``."""
    n, t_len, _ = log_probs.shape
    dev = log_probs.device
    labels = labels.to(device=dev, dtype=torch.int64)
    label_lengths = label_lengths.to(device=dev, dtype=torch.int64)
    input_lengths = input_lengths.to(device=dev, dtype=torch.int32).contiguous()
    s = 2 * labels.shape[1] + 1

    ext = labels.new_zeros((n, s))
    ext[:, 1::2] = labels
    prev2 = torch.nn.functional.pad(ext[:, :-2], (2, 0))
    can_skip = (ext != 0) & (ext != prev2)
    skip = torch.where(can_skip, 0.0, NEG_INF).to(torch.float32).contiguous()

    emit = log_probs.gather(2, ext[:, None, :].expand(n, t_len, s)).contiguous()  # [N, T, S]

    # alpha_0: only s=0 (blank) and s=1 (first label) are reachable; s=1
    # not when the label is empty.
    pos = torch.arange(s, device=dev)[None, :]
    alpha0 = torch.where(pos <= 1, emit[:, 0], NEG_INF)
    alpha0 = torch.where((pos == 1) & (label_lengths[:, None] == 0), NEG_INF, alpha0).contiguous()
    return emit, skip, alpha0, input_lengths


def ctc_loss_forward(log_probs, labels, input_lengths, label_lengths):
    """Per-sample CTC negative log-likelihood.

    :param log_probs: ``[N, T, C]`` float32 log-probabilities (class 0 = blank).
    :param labels: ``[N, L]`` int labels, 0-padded.
    :param input_lengths: ``[N]`` valid steps per sample.
    :param label_lengths: ``[N]`` valid labels per sample.
    :return: ``[N]`` negative log-likelihoods (1e30 where the labels cannot
        fit the input).
    """
    emit, skip, alpha0, input_lengths = ctc_operands(
        log_probs, labels, input_lengths, label_lengths)
    label_lengths = label_lengths.to(device=log_probs.device, dtype=torch.int64)

    if torch.is_grad_enabled() and (emit.requires_grad or alpha0.requires_grad):
        alpha_final = CTCAlphaFunction.apply(emit, skip, alpha0, input_lengths)
    else:
        alpha_final = ctc_alpha(emit, skip, alpha0, input_lengths, final_only=True)

    # Total log prob: last blank + last label positions.
    end = 2 * label_lengths
    a_end = alpha_final.gather(1, end[:, None])[:, 0]
    a_end1 = alpha_final.gather(1, (end - 1).clamp(min=0)[:, None])[:, 0]
    a_end1 = torch.where(label_lengths > 0, a_end1, NEG_INF)
    m = torch.maximum(a_end, a_end1)
    m_safe = torch.maximum(m, m.new_tensor(NEG_INF))
    total = m_safe + torch.log(torch.exp(a_end - m_safe) + torch.exp(a_end1 - m_safe))
    return -torch.where(m <= NEG_INF, torch.full_like(total, NEG_INF), total)


def ctc_loss(log_probs, labels, input_lengths, label_lengths):
    """CTC loss with torch's ``mean`` reduction: per-sample NLL divided by
    the target length (clamped to >= 1), averaged over the batch."""
    nll = ctc_loss_forward(log_probs, labels, input_lengths, label_lengths)
    denom = label_lengths.to(device=nll.device).clamp(min=1).to(nll.dtype)
    return (nll / denom).mean()
