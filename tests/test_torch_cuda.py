"""Kernels against their plain versions on the GPU (small shapes, bf16).

Marked `cuda`: they skip where no CUDA device is present, and run on the
card with `python -m pytest tests/test_torch_cuda.py --noconftest` (that
machine has no JAX, which `tests/conftest.py` imports).  `chip_smoke.py`
holds the same kernels at the main path's shapes.  Tolerances in bf16 are
atol + 2^-7 |y|: the last term is one bf16 ulp of the output (both sides
round to bf16), atol is each kernel's own (as in `chip_smoke.py`): 1e-2
for LayerNorm outputs of rms ~1, and for attention ~10% of the output's
rms (bf16 probabilities into PV, bf16 rel-pos terms).  float32 LayerNorm:
1e-5."""

import pytest
import torch

from crowdsam_tpu_torch.models import attention
from crowdsam_tpu_torch.models.image_encoder import _rel_pos_table
from crowdsam_tpu_torch.ops.layernorm import layer_norm, layer_norm_plain

pytestmark = pytest.mark.cuda


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, atol, rtol=2.0 ** -7):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= atol + rtol * want.abs()).all()


@pytest.mark.parametrize("n,d", [(1, 64), (37, 256), (1000, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_kernel(gen, n, d, dtype):
    x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    b = 0.1 * torch.randn(d, generator=gen, device="cuda")
    before = layer_norm.launches
    got = layer_norm(x, w, b, 1e-5)
    assert layer_norm.launches == before + 1
    if dtype == torch.bfloat16:
        _close(got, layer_norm_plain(x, w, b, 1e-5), 1e-2)
    else:
        _close(got, layer_norm_plain(x, w, b, 1e-5), 1e-5, 1e-5)


def test_window_attention_kernel(gen):
    ws, heads, hd, grid = 14, 2, 64, 28
    qkv = torch.randn((1, grid, grid, 3 * heads * hd), generator=gen,
                      device="cuda").bfloat16()
    rh = _rel_pos_table(0.1 * torch.randn((2 * ws - 1, hd), generator=gen,
                                          device="cuda"), ws)
    rw = _rel_pos_table(0.1 * torch.randn((2 * ws - 1, hd), generator=gen,
                                          device="cuda"), ws)
    got = attention.window_attention(qkv, rh, rw, heads, hd ** -0.5, ws)
    want = attention.window_attention_plain(qkv, rh, rw, heads, hd ** -0.5,
                                            ws)
    _close(got, want, 1.5e-2)


@pytest.mark.parametrize("valid", [None, 300])
def test_flash_kernels(gen, valid):
    g, heads, hd = 20, 2, 64
    qkv = torch.randn((1, g * g, 3 * heads * hd), generator=gen,
                      device="cuda").bfloat16()
    q, k, v = qkv.reshape(1, g * g, 3, heads, hd).permute(2, 0, 3, 1, 4)
    got = attention.flash_mha(q, k, v, 0.125, valid_len=valid)
    want = attention.flash_mha_plain(q, k, v, 0.125, valid)
    rows = valid or g * g
    _close(got[:, :, :rows], want[:, :, :rows], 6e-3)    # rms ~0.09
    rh = _rel_pos_table(0.1 * torch.randn((2 * g - 1, hd), generator=gen,
                                          device="cuda"), g)
    got = attention.flash_mha_decomposed_relpos(q, k, v, 0.125, rh, rh,
                                                (g, g))
    want = attention.relpos_attention_plain(q, k, v, 0.125, rh, rh, (g, g))
    _close(got, want, 1e-2)


def test_kernels_refuse_what_they_do_not_take(gen):
    x = torch.randn((1, 2, 16, 32), device="cuda").bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_mha(x, x, x, 0.125)
    with pytest.raises(TypeError):
        attention.flash_mha(*(torch.randn((1, 2, 16, 64), device="cuda"),) * 3,
                            0.125)
    w = torch.ones(1536, device="cuda")
    with pytest.raises(ValueError, match="width"):
        layer_norm(torch.randn((5, 1536), device="cuda"), w, w, 1e-5)
