"""The PyTorch port's CUDA kernel on the card.

These tests need a CUDA card and skip without one.  They import neither jax
nor the JAX package, so on the machine with the card they run without the
repo's conftest (which pins JAX to the CPU):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import pytest
import torch

from moolib_tpu_torch.models.transformer import TransformerLM, generate
from moolib_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}  # (out, lse) atol


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,D", [(1, 64), (77, 128), (200, 64), (513, 128)])
def test_flash_kernel_matches_plain_version(card, T, D, causal, dtype):
    g = torch.Generator(device=card).manual_seed(T * D + causal)
    q, k, v = (torch.randn(2, T, 3, D, generator=g, device=card).to(dtype) for _ in range(3))
    before = fa.flash_fwd_launches()
    out, lse = fa.flash_attention(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_fwd_launches() == before + 1
    p_out, p_lse = fa._blockwise_attention_plain(q.float(), k.float(), v.float(), causal)
    tol_out, tol_lse = TOL[dtype]
    assert out.dtype == dtype and lse.dtype == torch.float32 and lse.shape == (2, T, 3)
    assert (out.float() - p_out).abs().max().item() <= tol_out
    assert (lse - p_lse).abs().max().item() <= tol_lse


def test_flash_kernel_takes_strided_views(card):
    qkv = torch.randn(1, 130, 6, 64, device=card)
    q, k, v = qkv[:, :, :2], qkv[:, :, 2:4], qkv[:, :, 4:]
    out = fa.flash_attention(q, k, v)
    want, _ = fa._blockwise_attention_plain(q, k, v, True)
    assert (out - want).abs().max().item() <= 1e-4


def test_flash_kernel_backward_raises(card):
    q = torch.randn(1, 64, 2, 64, device=card, requires_grad=True)
    out = fa.flash_attention(q, q.detach(), q.detach())
    with pytest.raises(NotImplementedError, match="slice 2"):
        out.sum().backward()


def test_flash_model_matches_dense_model_on_card(card):
    cfg = dict(vocab_size=128, d_model=128, num_heads=2, num_kv_heads=1, num_layers=2,
               max_len=160, dtype=torch.float32, pos_embedding="rotary", device=card)
    flash = TransformerLM(attention="flash", generator=torch.Generator().manual_seed(0), **cfg)
    dense = TransformerLM(attention="dense", generator=torch.Generator().manual_seed(0), **cfg)
    tokens = torch.randint(0, 128, (2, 150), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        tokens = tokens.to(card)
        assert (flash(tokens) - dense(tokens)).abs().max().item() <= 1e-3
        assert torch.equal(generate(flash, tokens[:, :100], 8), generate(dense, tokens[:, :100], 8))
