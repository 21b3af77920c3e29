"""chip_smoke.py's checks that need no card: kernel names from the
machine code, the tensor-core check of the build phase, and the bounds
the kernel line reports."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

# Mangled names as cuobjdump prints them (nvcc's name for the anonymous
# namespace, then the kernel): the float32 forward keeps its dtype template
# argument, the other float32 kernels take float pointers.
NS = "_ZN45_GLOBAL__N__6dea7cfa_12_flash_bwd_cu_8cda65cb"
MANGLED = {
    "flash_fwd_wgmma_kernel<bf16,128,causal>":
        NS + "22flash_fwd_wgmma_kernelILi128ELb1EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiif",
    "flash_fwd_kernel<f32,64,full>":
        NS + "16flash_fwd_kernelIfLi64ELb0EEEvPKT_S3_S3_PS1_Pfiiif",
    "flash_bwd_dq_wgmma_kernel<bf16,64,full>":
        NS + "25flash_bwd_dq_wgmma_kernelILi64ELb0EEEvPK13__nv_bfloat16S3_S3_S3_"
        "PKfS5_PS1_iiif",
    "flash_bwd_dq_kernel<f32,128,causal>":
        NS + "19flash_bwd_dq_kernelILi128ELb1EEEvPKfS2_S2_S2_S2_S2_Pfiiif",
    "flash_bwd_dkv_wgmma_kernel<bf16,128,full>":
        NS + "26flash_bwd_dkv_wgmma_kernelILi128ELb0EEEvPK13__nv_bfloat16S3_S3_S3_"
        "PKfS5_PS1_S6_iiif",
    "flash_bwd_dkv_kernel<f32,64,causal>":
        NS + "20flash_bwd_dkv_kernelILi64ELb1EEEvPKfS2_S2_S2_S2_S2_PfS3_iiif",
}

WGMMA = [f"{kernel}<bf16,{d},{mode}>"
         for kernel in ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                        "flash_bwd_dkv_wgmma_kernel")
         for d in (64, 128) for mode in ("causal", "full")]


def _complete_report() -> dict:
    """What the build phase reads from a good build: HGMMA in every bf16
    wgmma kernel, the float32 CUDA-core kernels without tensor-core code."""
    report = {name: {"HGMMA": 16, "HMMA": 0} for name in WGMMA}
    for kernel in ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
        for d in (64, 128):
            for mode in ("causal", "full"):
                report[f"{kernel}<f32,{d},{mode}>"] = {"HGMMA": 0, "HMMA": 0}
    return report


@pytest.mark.parametrize("label", sorted(MANGLED))
def test_kernel_label_reads_mangled_names(label):
    assert chip_smoke.kernel_label(MANGLED[label]) == label


def test_check_tensor_cores_passes_on_a_complete_report():
    chip_smoke.check_tensor_cores(_complete_report())


@pytest.mark.parametrize("name", WGMMA)
def test_check_tensor_cores_fails_without_hgmma(name):
    report = _complete_report()
    report[name]["HGMMA"] = 0
    with pytest.raises(AssertionError, match="no HGMMA"):
        chip_smoke.check_tensor_cores(report)


@pytest.mark.parametrize("kernel", ["flash_fwd_kernel", "flash_bwd_dq_kernel",
                                    "flash_bwd_dkv_kernel"])
def test_check_tensor_cores_fails_on_a_bf16_cuda_core_kernel(kernel):
    report = _complete_report()
    report[f"{kernel}<bf16,128,causal>"] = {"HGMMA": 0, "HMMA": 0}
    with pytest.raises(AssertionError, match="CUDA-core"):
        chip_smoke.check_tensor_cores(report)


# At the training shape (16, 1024, 8, 128) bf16 causal: 524,800 attended
# pairs per head, 128 heads; GFLOP, bound ms and what bounds it.
TRAIN_BOUNDS = {"flash_fwd": (34.4, 0.0402, "bytes"),
                "flash_bwd_dq": (51.6, 0.0522, "operations"),
                "flash_bwd_dkv": (68.8, 0.0696, "operations")}


@pytest.mark.parametrize("name", sorted(TRAIN_BOUNDS))
def test_flash_bounds_at_training_shape(name):
    ms, by, ops = chip_smoke.flash_bounds(16, 1024, 8, 128, torch.bfloat16, True)[name]
    gflop, want_ms, want_by = TRAIN_BOUNDS[name]
    assert round(ops / 1e9, 1) == gflop
    assert round(ms, 4) == want_ms
    assert by == want_by
