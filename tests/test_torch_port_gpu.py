"""The fused sweep's CUDA kernel against its plain PyTorch version, on the
card. Marked `gpu`; skipped where there is no CUDA device. Run on the
H100 with `python -m pytest tests/test_torch_port_gpu.py -m gpu`.

Tolerances: float32 1e-4 * max(1, max |plain|): both sum the same fp32
products in another order, from tap coordinates that round differently.
bf16 1e-2 * max(1, max |plain|): a last-bit difference in a float32
sample can flip its rounding to bf16 (a 2^-8 relative step) in the MLP
input.
"""

import pytest
import torch

from simplerecon_tpu_torch.ops import cuda_cv
from simplerecon_tpu_torch.testing import sweep_case

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 3, 13, 21, 8, 5),
                                   (1, 7, 96, 128, 16, 64)],
                         ids=["odd", "hero"])
def test_kernel_matches_plain_version(cuda, dtype, shape):
    args = sweep_case(*shape, dtype=dtype, device=cuda, seed=1)
    before = cuda_cv.fused_sweep.launches
    with torch.no_grad():
        got = cuda_cv.fused_sweep(*args)
        want = cuda_cv.fused_sweep_reference(*args)
    torch.cuda.synchronize()
    assert cuda_cv.fused_sweep.launches == before + 1
    b, k, h, w, c, d = shape
    assert got.shape == (b, d, h * w) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= TOL[dtype] * max(1.0, want.abs().max().item()), err


def test_kernel_wrapper_rejects_what_it_does_not_take(cuda):
    args = sweep_case(1, 2, 8, 8, 4, 3, dtype=torch.float32, device=cuda)
    bad = list(args)
    bad[0] = args[0].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_cv.fused_sweep(*bad)
    bad = list(args)
    bad[1] = args[1].to(torch.bfloat16)
    with pytest.raises(TypeError):
        cuda_cv.fused_sweep(*bad)
    bad = list(args)
    bad[8] = args[8].clone().requires_grad_()
    with pytest.raises(NotImplementedError):
        cuda_cv.fused_sweep(*bad)
