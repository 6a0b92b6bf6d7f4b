"""``profile_kernels``' reading of device records, on made-up profiles: a
kernel of the port's own is its mean record times its wrapper's launches
per iteration, so a record the profiler did not deliver costs nothing; a
library kernel is the sum of its records over the iterations."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from ocrs_models_torch.profile_kernels import device_ms_by_kernel, own_wrapper


def _event(name, us, device=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=0.0, end=us))


def _profile(events):
    return SimpleNamespace(events=lambda: events)


def test_own_kernels_read_mean_record_times_launches():
    # 5 iterations; each launches gru_bwd twice (two layers), and the
    # profiler delivered 8 of the chain kernel's 10 records; ctc_alpha once
    # an iteration, 4 records of 5.
    events = [_event("gru_bwd_chain_kernel(float const*, float*)", 700.0) for _ in range(8)]
    events += [_event("void ctc_alpha_kernel<8>(float const*)", 40.0) for _ in range(4)]
    events += [_event("sm90_xmma_gemm_f32f32", 100.0) for _ in range(9)]
    events += [_event("cudaLaunchKernel", 5.0, device=DeviceType.CPU)]
    launches = {"stage1_fwd": 1, "stage1_bwd": 1, "gru_fwd": 2, "gru_bwd": 2, "ctc_alpha": 1,
                "ctc_beta": 1}
    got = device_ms_by_kernel(_profile(events), 5, launches)
    assert got.keys() == {"gru_bwd_chain_kernel(float const*, float*)",
                          "void ctc_alpha_kernel<8>(float const*)", "sm90_xmma_gemm_f32f32"}
    assert got["gru_bwd_chain_kernel(float const*, float*)"] == pytest.approx(1.4)
    assert got["void ctc_alpha_kernel<8>(float const*)"] == pytest.approx(0.04)
    assert got["sm90_xmma_gemm_f32f32"] == pytest.approx(9 * 0.1 / 5)


@pytest.mark.parametrize("name,wrapper", [
    ("stage1_fwd_kernel(float const*)", "stage1_fwd"),
    ("stage1_bwd_partial_kernel(float const*)", "stage1_bwd"),
    ("gru_bwd_dw_sum_kernel(float*)", "gru_bwd"),
    ("void ctc_beta_kernel<8>(float const*)", "ctc_beta"),
    ("void at::native::vectorized_elementwise_kernel<4>", None),
    ("Memcpy HtoD (Pinned -> Device)", None),
])
def test_own_wrapper(name, wrapper):
    assert own_wrapper(name) == wrapper
