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
    BiGRU,
    gru_bwd,
    gru_bwd_chain_bf16_reference,
    gru_bwd_chain_reference,
    gru_bwd_coefficients_reference,
    gru_bwd_dw_bf16_reference,
    gru_bwd_dw_reference,
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
of the wide route in either of its forms, :func:`gru_route`)."""

__all__ = [
    "BiGRU", "DTYPES", "KERNELS", "ctc_alpha", "ctc_alpha_chain_probe", "ctc_alpha_reference",
    "ctc_beta", "ctc_beta_chain_probe", "ctc_beta_reference", "ctc_design", "ctc_loss",
    "ctc_loss_forward", "ctc_operands", "gru_bwd", "gru_bwd_chain_bf16_reference", "gru_bwd_chain_reference",
    "gru_bwd_coefficients_reference", "gru_bwd_dw_bf16_reference", "gru_bwd_dw_reference",
    "gru_bwd_phases_reference", "gru_bwd_reference", "gru_fwd", "gru_recurrence",
    "gru_recurrence_reference", "gru_route", "gru_wide_bwd", "gru_wide_fwd", "stage1",
    "stage1_bwd", "stage1_bwd_grid", "stage1_bwd_reference", "stage1_fwd", "stage1_reference",
]
