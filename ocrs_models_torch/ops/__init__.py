from ._build import DTYPES
from .ctc import (
    ctc_alpha,
    ctc_alpha_chain_probe,
    ctc_alpha_reference,
    ctc_beta,
    ctc_beta_chain_probe,
    ctc_beta_reference,
    ctc_design,
    ctc_loss,
    ctc_loss_forward,
    ctc_operands,
)
from .gru import (
    PHASE_KERNELS,
    BiGRU,
    gru_bwd,
    gru_bwd_chain_bf16_reference,
    gru_bwd_chain_reference,
    gru_bwd_coef_wide_f32,
    gru_bwd_coefficients_reference,
    gru_bwd_dw_bf16_reference,
    gru_bwd_dw_reference,
    gru_bwd_dw_wide_f32,
    gru_bwd_phases_reference,
    gru_bwd_reference,
    gru_fwd,
    gru_recurrence,
    gru_recurrence_reference,
    gru_route,
    gru_wide_bwd,
    gru_wide_fwd,
)
from .stage1 import (
    stage1,
    stage1_bwd,
    stage1_bwd_grid,
    stage1_bwd_reference,
    stage1_fwd,
    stage1_reference,
)

KERNELS = (stage1_fwd, stage1_bwd, gru_fwd, gru_bwd, gru_wide_fwd, gru_wide_bwd, ctc_alpha,
           ctc_beta)
"""Every kernel wrapper; each counts its launches in ``.launches`` (``gru_fwd``
and ``gru_bwd`` those of the cluster route, the ``gru_wide_*`` wrappers those
of the wide route in either of its forms, :func:`gru_route`). ``PHASE_KERNELS``
are the wrappers of the f32 wide backward's ``coef`` and ``dw`` above 512,
which ``gru_wide_bwd`` calls (their launches are within its own)."""

__all__ = [
    "BiGRU", "DTYPES", "KERNELS", "PHASE_KERNELS", "ctc_alpha", "ctc_alpha_chain_probe", "ctc_alpha_reference",
    "ctc_beta", "ctc_beta_chain_probe", "ctc_beta_reference", "ctc_design", "ctc_loss",
    "ctc_loss_forward", "ctc_operands", "gru_bwd", "gru_bwd_chain_bf16_reference", "gru_bwd_chain_reference",
    "gru_bwd_coef_wide_f32", "gru_bwd_coefficients_reference", "gru_bwd_dw_bf16_reference",
    "gru_bwd_dw_reference", "gru_bwd_dw_wide_f32",
    "gru_bwd_phases_reference", "gru_bwd_reference", "gru_fwd", "gru_recurrence",
    "gru_recurrence_reference", "gru_route", "gru_wide_bwd", "gru_wide_fwd", "stage1",
    "stage1_bwd", "stage1_bwd_grid", "stage1_bwd_reference", "stage1_fwd", "stage1_reference",
]
