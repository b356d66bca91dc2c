"""The two-way transformer of the fused decode as one kernel call (K5):
`csrc/decode_tail.cu`, its wrapper `twoway_tail` and its plain PyTorch
version `twoway_tail_plain`.

Replaces the JAX package's Pallas `twoway_tail_pallas`
(crowdsam_tpu/models/decode_tail_kernel.py:359): for each prompt, both
two-way blocks (token self-attention, token->image attention, ReLU MLP,
image->token update + LayerNorm) and the final token->image attention +
LayerNorm, from the per-image shared tensors of
`fused_decode.precompute_decode_shared`.  Outputs the per-prompt image
tensor keys2 (P, M, C) and the final tokens (P, T, C).

Image axis: the image-side operands (keys0 and block 1's q1i/k1/v1) may
hold B images, (B, M, C) and (B, M, 128), with an int32 image index per
prompt, `img` (P,); each prompt then reads its own image's rows.  The
(M, C) form is the case B = 1.  The PE-side parameters and the weights do
not depend on the image and stay shared.  One call covers the prompts of
every image: still ten kernel launches whatever B is.

Numerics, the same in the kernel and the plain version: operands rounded to the
working dtype (bf16 on the card), f32 accumulation, a rounding after each dense
stage, f32 softmax and LayerNorm statistics (eps 1e-5), ReLU MLP; the softmax
of every head is taken on its own.  The tokens' residual stream stays f32:
their LayerNorms take the f32 sum of the state and a dense output and give an
f32 state, rounded only where it feeds a product (a state rounded after every
LayerNorm let two computations whose f32 sums differ in the last bits part by a
bf16 step, and the chain of seven LayerNorms carried such steps to the output).
The image side's LayerNorms round their input and output, as the image tensors
are bf16.  Probabilities that feed a tensor-core product are rounded to the
working dtype first: the image->token ones before the rank-(8 T) update, and
the token->image exponentials tile by tile (the softmax over all image rows is
split over tiles of ROW_TILE rows and merged in f32); the token
self-attention's stay f32.

Float32 (`tpu.compute_dtype float32`): every operand and parameter float32
goes to the float32 arm, `csrc/decode_tail_f32.cu` (sixteen launches, see
the source's note): float32 arithmetic with every product in 3xTF32 on the
tensor cores, the rounding points above the identity; its weights are
split and packed once (`PACKED`, `tf32x3.packed`), and
`twoway_tail_tf32x3_model` writes its arithmetic out in PyTorch.  The plain
version follows its input's dtype: float32 arithmetic for bf16 and float32
operands, float64 for float64 ones (the yardstick the card holds the
float32 arm to).

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel of the operands' dtype (bf16 or float32) or raises.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from crowdsam_tpu_torch.kernels import _build
from crowdsam_tpu_torch.models import tf32x3

# Kernel parameters in the order `csrc/decode_tail.cu` and
# `csrc/decode_tail_f32.cu` index them (enum Param there).  `*_w` are Linear
# weights (out, in) in the working dtype, the (M, 128) PE-side projections
# likewise; biases and LayerNorm parameters are f32.
PARAM_NAMES = (
    "kpe2", "qpe2i", "kpef",          # (M, 128) PE-side projections
    "wide2", "widef",                  # (384, 256) / (256, 256)
    "bv2", "bvf",                      # (128,)
    "t2i_q_w", "t2i_q_b", "t2i_o_w", "t2i_o_b",
    "n2_w", "n2_b", "n3_w", "n3_b", "n4_w", "n4_b", "nf_w", "nf_b",
    "mlp1_w", "mlp1_b", "mlp2_w", "mlp2_b",
    "i2t_k_w", "i2t_k_b", "i2t_v_w", "i2t_v_b", "i2t_o_w", "i2t_o_b",
    "fin_q_w", "fin_q_b", "fin_o_w", "fin_o_b",
    # block 1: image->token update
    "i2t1_k_w", "i2t1_k_b", "i2t1_v_w", "i2t1_v_b", "i2t1_o_w", "i2t1_o_b",
    "n4l0_w", "n4l0_b",
    # block 1: token side
    "l0sa_q_w", "l0sa_q_b", "l0sa_k_w", "l0sa_k_b",
    "l0sa_v_w", "l0sa_v_b", "l0sa_o_w", "l0sa_o_b", "n1l0_w", "n1l0_b",
    "t2i1_q_w", "t2i1_q_b", "t2i1_o_w", "t2i1_o_b", "n2l0_w", "n2l0_b",
    "mlp1l0_w", "mlp1l0_b", "mlp2l0_w", "mlp2l0_b", "n3l0_w", "n3l0_b",
    # block 2: token self-attention
    "l1sa_q_w", "l1sa_q_b", "l1sa_k_w", "l1sa_k_b",
    "l1sa_v_w", "l1sa_v_b", "l1sa_o_w", "l1sa_o_b", "n1l1_w", "n1l1_b",
)

# The float32 arm's packed weights (`tf32x3.packed`: split into TF32 hi +
# lo once and laid out as the kernel's stages), in the order of `enum
# Packed` in `csrc/decode_tail_f32.cu`: (parameter, packing).  The MLPs'
# second weights are packed as 8 blocks of 256 inputs (the kernel's
# K-split), the image updates' out-projections as 8 heads of 16 inputs
# (the fold, a product per head).
PACKED = (
    ("wide2", "plain"), ("widef", "plain"),
    ("l0sa_q_w", "plain"), ("l0sa_k_w", "plain"), ("l0sa_v_w", "plain"),
    ("l0sa_o_w", "plain"), ("t2i1_q_w", "plain"), ("t2i1_o_w", "plain"),
    ("mlp1l0_w", "plain"), ("mlp2l0_w", "columns:256"),
    ("i2t1_k_w", "plain"), ("i2t1_v_w", "plain"),
    ("i2t1_o_w", "columns:16"),
    ("l1sa_q_w", "plain"), ("l1sa_k_w", "plain"), ("l1sa_v_w", "plain"),
    ("l1sa_o_w", "plain"), ("t2i_q_w", "plain"), ("t2i_o_w", "plain"),
    ("mlp1_w", "plain"), ("mlp2_w", "columns:256"),
    ("i2t_k_w", "plain"), ("i2t_v_w", "plain"), ("i2t_o_w", "columns:16"),
    ("fin_q_w", "plain"), ("fin_o_w", "plain"),
)

EMBED_DIM = 256         # C
INTERNAL_DIM = 128      # cross-attention width (C / 2)
NUM_HEADS = 8
ROW_TILE = 64           # image rows per block of the row phases
MAX_TOKENS = 8          # 5 output tokens + up to 3 sparse tokens
MLP_DIM = 2048          # the two-way blocks' MLP width (SAM's)
LN_EPS = 1e-5


def build_tail_params(decoder, shared: Dict, dtype: torch.dtype
                      ) -> Dict[str, torch.Tensor]:
    """The kernel's parameters from the port's `MaskDecoder` and the shared
    PE-side tensors of `precompute_decode_shared`: weights in `dtype`,
    biases and LayerNorm parameters in f32, all contiguous."""
    t = decoder.transformer
    l0, l1, fin = t.layers[0], t.layers[1], t.final_attn_token_to_image
    out: Dict[str, torch.Tensor] = {}

    def lin(prefix, layer):
        out[f"{prefix}_w"] = layer.weight.detach().to(dtype).contiguous()
        out[f"{prefix}_b"] = layer.bias.detach().float().contiguous()

    def norm(prefix, layer):
        out[f"{prefix}_w"] = layer.weight.detach().float().contiguous()
        out[f"{prefix}_b"] = layer.bias.detach().float().contiguous()

    def attn(prefix, layer, names="qkvo"):
        for n in names:
            lin(f"{prefix}_{n}", getattr(
                layer, "out_proj" if n == "o" else f"{n}_proj"))

    for k in ("kpe2", "qpe2i", "kpef", "wide2", "widef"):
        out[k] = shared[k].to(dtype).contiguous()
    for k in ("bv2", "bvf"):
        out[k] = shared[k].float().contiguous()
    attn("t2i", l1.cross_attn_token_to_image, "qo")
    norm("n2", l1.norm2)
    norm("n3", l1.norm3)
    norm("n4", l1.norm4)
    norm("nf", t.norm_final_attn)
    lin("mlp1", l1.mlp.lin1)
    lin("mlp2", l1.mlp.lin2)
    attn("i2t", l1.cross_attn_image_to_token, "kvo")
    attn("fin", fin, "qo")
    attn("i2t1", l0.cross_attn_image_to_token, "kvo")
    norm("n4l0", l0.norm4)
    attn("l0sa", l0.self_attn)
    norm("n1l0", l0.norm1)
    attn("t2i1", l0.cross_attn_token_to_image, "qo")
    norm("n2l0", l0.norm2)
    lin("mlp1l0", l0.mlp.lin1)
    lin("mlp2l0", l0.mlp.lin2)
    norm("n3l0", l0.norm3)
    attn("l1sa", l1.self_attn)
    norm("n1l1", l1.norm1)
    assert set(out) == set(PARAM_NAMES)
    return out


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """(..., N, c) -> (..., h, N, c/h)."""
    *b, n, c = x.shape
    return x.reshape(*b, n, h, c // h).transpose(-2, -3)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """(..., h, N, d) -> (..., N, h*d)."""
    *b, h, n, d = x.shape
    return x.transpose(-2, -3).reshape(*b, n, h * d)


def _with_pe(x: torch.Tensor, pe: torch.Tensor) -> torch.Tensor:
    """Token state plus the query PE (the initial tokens)."""
    return x + pe


class _Stages:
    """The dense and LayerNorm stages of the plain version: f32 arithmetic
    (f64 for a f64 working dtype) on values rounded to the working dtype
    `dt` where the kernel rounds."""

    def __init__(self, params: Dict[str, torch.Tensor], dt: torch.dtype):
        self.params, self.dt = params, dt
        self.acc = torch.float64 if dt == torch.float64 else torch.float32

    def rnd(self, x):
        return x.to(self.dt).to(self.acc)

    def par(self, name):
        return self.params[name].to(self.acc)

    def mm(self, x, w, name):
        """x @ w^T: every product of the kernel's tensor cores (a dense
        layer's weight `name`, "wide2", "widef")."""
        return x @ w.T

    def fold(self, v_tok, w_o):
        """The out-projection folded onto the token values, (P, H, T, d) x
        (C, H, d) -> (P, H, T, C)."""
        return torch.einsum("phtd,chd->phtc", v_tok, w_o)

    def expand(self, p, u):
        """The rank-(H T) image update, (P, H, M, T) x (P, H, T, C) ->
        (P, M, C)."""
        return torch.einsum("phmt,phtc->pmc", p, u)

    def dense(self, x, pfx):
        return self.rnd(self.mm(self.rnd(x), self.par(f"{pfx}_w"), pfx)
                        + self.par(f"{pfx}_b"))

    def ln32(self, x, pfx):
        """LayerNorm of x in f32, the output f32."""
        u = x.mean(-1, keepdim=True)
        s = (x - u).square().mean(-1, keepdim=True)
        y = (x - u) * torch.rsqrt(s + LN_EPS)
        return y * self.par(f"{pfx}_w") + self.par(f"{pfx}_b")


def _t2i_attend(st: _Stages, qh: torch.Tensor, k_img: torch.Tensor,
                v_img: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Token->image attention, every head's softmax over all image rows, in
    the kernel's split form: per tile of ROW_TILE rows the max, the
    exponentials (rounded: a tensor-core operand), their sum and their
    product with v; then the tiles merged with f32 rescales.
    qh (P, T, c); k_img, v_img (M, c) shared or (P, M, c); f32 in and out:
    (P, T, c)."""
    q = _heads(qh, num_heads)                              # (P, H, T, d)
    k, v = _heads(k_img, num_heads), _heads(v_img, num_heads)
    m, d = k.shape[-2], k.shape[-1]
    tile = ROW_TILE if m % ROW_TILE == 0 else m
    s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(d))   # (P, H, T, M)
    s = s.reshape(*s.shape[:-1], m // tile, tile)
    mt = s.amax(dim=-1)                                    # (P, H, T, NT)
    e = st.rnd(torch.exp(s - mt[..., None]))
    lt = e.sum(dim=-1)
    vt = v.reshape(*v.shape[:-2], m // tile, tile, d)      # (.., H, NT, r, d)
    acc = torch.einsum("phtnr,hnrd->phtnd" if vt.dim() == 4
                       else "phtnr,phnrd->phtnd", e, vt)
    w = torch.exp(mt - mt.amax(dim=-1, keepdim=True))
    out = (w[..., None] * acc).sum(dim=-2) / (w * lt).sum(dim=-1)[..., None]
    return _merge(out)


def _image_update(st: _Stages, prev, q_img, tok, pe, pfx: str, npfx: str,
                  num_heads: int) -> torch.Tensor:
    """LN(prev + out_proj(attn(q=image, k=tokens + PE, v=tokens))): every
    head's softmax over the tokens, the probabilities rounded, the
    out-projection folded onto the token values; the LayerNorm of the f32
    sum, its output rounded."""
    k_tok = _heads(st.dense(_with_pe(tok, pe), f"{pfx}_k"), num_heads)
    v_tok = _heads(st.dense(tok, f"{pfx}_v"), num_heads)   # (P, H, T, d)
    scale = 1.0 / math.sqrt(k_tok.shape[-1])
    qi = _heads(q_img, num_heads)                   # (H, M, d) or (P, H, M, d)
    p = st.rnd(torch.softmax((qi @ k_tok.transpose(-1, -2)) * scale, dim=-1))
    w_o = st.par(f"{pfx}_o_w")                      # (C, H*d)
    u = st.rnd(st.fold(v_tok, w_o.reshape(w_o.shape[0], num_heads, -1)))
    delta = st.expand(p, u)
    # The LayerNorm's input sum stays f32 (the kernel forms it twice).
    return st.rnd(st.ln32(prev + st.rnd(delta) + st.par(f"{pfx}_o_b"),
                          npfx))


def _image_rows(keys0, q1i, k1, v1, img):
    """The image-side operands as (B, M, .) and the per-prompt image
    index (P,) int64 on their device (zeros when `img` is None, which
    needs B = 1)."""
    ops = [x if x.dim() == 3 else x[None] for x in (keys0, q1i, k1, v1)]
    b = ops[0].shape[0]
    if any(x.shape[0] != b for x in ops):
        raise ValueError("twoway_tail: keys0, q1i, k1 and v1 must hold the "
                         "same number of images")
    if img is None and b != 1:
        raise ValueError(f"twoway_tail: {b} images need an image index per "
                         "prompt")
    return ops, b


def twoway_tail_plain(keys0: torch.Tensor, q1i: torch.Tensor,
                      k1: torch.Tensor, v1: torch.Tensor,
                      tokens: torch.Tensor, params: Dict[str, torch.Tensor],
                      num_heads: int = NUM_HEADS,
                      img: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `twoway_tail` (same contract), in f32 (f64 for f64
    operands) with the kernel's rounding points; the working dtype is
    keys0's.  With B > 1
    images, one single-image computation a present image over its prompts,
    the results put back in prompt order."""
    return _tail_images(keys0, q1i, k1, v1, tokens, params, num_heads, img,
                        _Stages)


def _tail_images(keys0, q1i, k1, v1, tokens, params, num_heads, img, stages):
    """`twoway_tail_plain` with its products made by `stages(params,
    dtype)` (`_Stages`; the float32 arm's model passes its own)."""
    (keys0, q1i, k1, v1), b = _image_rows(keys0, q1i, k1, v1, img)
    if b == 1:
        return _tail_one(keys0[0], q1i[0], k1[0], v1[0], tokens, params,
                         num_heads, stages)
    img = img.to(device=tokens.device, dtype=torch.int64)
    if bool(((img < 0) | (img >= b)).any()):
        raise ValueError(f"twoway_tail: image index outside 0..{b - 1}")
    keys2 = torch.empty((tokens.shape[0],) + keys0.shape[1:],
                        dtype=keys0.dtype, device=keys0.device)
    tok = torch.empty(tokens.shape, dtype=keys0.dtype, device=keys0.device)
    for i in range(b):
        rows = torch.nonzero(img == i).flatten()
        if rows.numel():
            keys2[rows], tok[rows] = _tail_one(
                keys0[i], q1i[i], k1[i], v1[i], tokens[rows], params,
                num_heads, stages)
    return keys2, tok


def _tail_one(keys0: torch.Tensor, q1i: torch.Tensor, k1: torch.Tensor,
              v1: torch.Tensor, tokens: torch.Tensor,
              params: Dict[str, torch.Tensor], num_heads: int,
              stages=_Stages) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version on one image's operands (M, .)."""
    dt = keys0.dtype
    H = num_heads
    st = stages(params, dt)
    rnd, par, dense, ln = st.rnd, st.par, st.dense, st.ln32

    def self_attn(x_qk, x_v, pfx):
        q = _heads(dense(x_qk, f"{pfx}_q"), H)
        k = _heads(dense(x_qk, f"{pfx}_k"), H)
        v = _heads(dense(x_v, f"{pfx}_v"), H)
        scale = 1.0 / math.sqrt(q.shape[-1])
        p = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
        return dense(_merge(p @ v), f"{pfx}_o")

    def cross_t2i(q_tok, k_img, v_img, pfx):
        return dense(_t2i_attend(st, q_tok, k_img, v_img, H), f"{pfx}_o")

    cd = q1i.shape[-1]
    keys0f, q1f, k1f, v1f = (x.to(st.acc) for x in (keys0, q1i, k1, v1))
    pe = tokens.to(dt).to(st.acc)                      # == query_pe

    # block 1, token side (no PE on the first self-attention)
    queries = ln(self_attn(pe, pe, "l0sa"), "n1l0")
    qh = dense(_with_pe(queries, pe), "t2i1_q")
    queries = ln(queries + cross_t2i(qh, k1f, v1f, "t2i1"), "n2l0")
    mlp = dense(torch.relu(dense(queries, "mlp1l0")), "mlp2l0")
    qb1 = ln(queries + mlp, "n3l0")
    # block 1, image side
    keys1 = _image_update(st, keys0f[None], q1f, qb1, pe, "i2t1", "n4l0", H)

    # block 2
    queries = ln(qb1 + self_attn(_with_pe(qb1, pe), qb1, "l1sa"), "n1l1")
    kvq = st.mm(keys1, par("wide2"), "wide2")          # (P, M, 3*cd)
    k2 = rnd(kvq[..., :cd] + par("kpe2"))
    v2 = rnd(kvq[..., cd:2 * cd] + par("bv2"))
    q2i = rnd(kvq[..., 2 * cd:] + par("qpe2i"))
    qh = dense(_with_pe(queries, pe), "t2i_q")
    queries = ln(queries + cross_t2i(qh, k2, v2, "t2i"), "n2")
    mlp = dense(torch.relu(dense(queries, "mlp1")), "mlp2")
    queries = ln(queries + mlp, "n3")
    keys2 = _image_update(st, keys1, q2i, queries, pe, "i2t", "n4", H)

    # final token -> image attention
    kvf = st.mm(keys2, par("widef"), "widef")
    kf = rnd(kvf[..., :cd] + par("kpef"))
    vf = rnd(kvf[..., cd:] + par("bvf"))
    qh = dense(_with_pe(queries, pe), "fin_q")
    queries = ln(queries + cross_t2i(qh, kf, vf, "fin"), "nf")
    return keys2.to(dt), queries.to(dt)


# ---------------------------------------------------------------------------
# the float32 arm's arithmetic
# ---------------------------------------------------------------------------

# The faults of the float32 arm's design that its model computes: those of
# every product, and a prompt's image update taking the next prompt's
# folded values (the packed values the token stage writes a prompt).
TWOWAY_FAULTS = tf32x3.PRODUCT_FAULTS + (
    "a prompt's folded values from the next prompt",)


class _TF32x3Stages(_Stages):
    """The float32 arm's products (`csrc/decode_tail_f32.cu`) in 3xTF32
    (`tf32x3.mm`, 32 inputs a stage): the dense layers and the wide
    products; the MLP's 2048-deep second product as 8 partials of 256
    inputs summed in order (the kernel's K-split); the fold per head (16
    inputs); the image update over the (head, token) axis with 8 tokens a
    head, the padding tokens zero, as the kernel lays out the folded
    values.  `fault`: one of `TWOWAY_FAULTS` or None."""

    fault: Optional[str] = None

    def _product_fault(self):
        return self.fault if self.fault in tf32x3.PRODUCT_FAULTS else None

    def mm(self, x, w, name):
        f = self._product_fault()
        if not name.startswith("mlp2"):
            return tf32x3.mm(x, w, f)
        out = None
        for j in range(0, w.shape[1], EMBED_DIM):
            part = tf32x3.mm(x[..., j:j + EMBED_DIM], w[:, j:j + EMBED_DIM],
                             f)
            out = part if out is None else out + part
        return out

    def fold(self, v_tok, w_o):
        f = self._product_fault()
        return torch.stack([tf32x3.mm(v_tok[:, h], w_o[:, h], f)
                            for h in range(v_tok.shape[1])], dim=1)

    def expand(self, p, u):
        n, h, m, t = p.shape
        pad = MAX_TOKENS - t
        a = torch.nn.functional.pad(p, (0, pad)).permute(0, 2, 1, 3)
        w = torch.nn.functional.pad(u, (0, 0, 0, pad)).permute(0, 3, 1, 2)
        w = w.reshape(n, w.shape[1], h * MAX_TOKENS)
        if self.fault == TWOWAY_FAULTS[-1]:
            w = w.roll(-1, 0)
        return tf32x3.mm(a.reshape(n, m, h * MAX_TOKENS), w,
                         self._product_fault())


def twoway_tail_tf32x3_model(keys0: torch.Tensor, q1i: torch.Tensor,
                             k1: torch.Tensor, v1: torch.Tensor,
                             tokens: torch.Tensor,
                             params: Dict[str, torch.Tensor],
                             img: Optional[torch.Tensor] = None,
                             fault: Optional[str] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float32 arm's arithmetic in PyTorch on float32 operands (CPU or
    CUDA): `twoway_tail_plain` with its products in 3xTF32
    (`_TF32x3Stages`); the softmaxes, LayerNorms and the token->image
    partials as the plain version computes them (the kernel's CUDA cores).
    `fault`, one of `TWOWAY_FAULTS`, computes it with that fault of the
    design.  For the tests and chip_smoke.py's faults: no path calls it."""
    tf32x3.check_fault(fault, TWOWAY_FAULTS)
    if keys0.dtype != torch.float32:
        raise TypeError("twoway_tail_tf32x3_model: float32 operands")
    stages = type("_Model", (_TF32x3Stages,), {"fault": fault})
    return _tail_images(keys0, q1i, k1, v1, tokens, params, NUM_HEADS, img,
                        stages)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

_ARGTYPES = ((ctypes.c_void_p,) * 18 + (ctypes.c_int,) * 5
             + (ctypes.c_void_p,))
_F32_ARGTYPES = ((ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 5
                 + (ctypes.c_void_p,))


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    _build.require_operand("twoway_tail", t, name, shape, dtype, device)


def twoway_tail(keys0: torch.Tensor, q1i: torch.Tensor, k1: torch.Tensor,
                v1: torch.Tensor, tokens: torch.Tensor,
                params: Dict[str, torch.Tensor], num_heads: int = NUM_HEADS,
                img: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole two-way transformer for P prompts (K5).

    keys0 (M, 256) or (B, M, 256): image embedding + no-mask embedding;
    q1i, k1, v1 (M, 128) or (B, M, 128): block 1's image-side projections,
    shared by the prompts of an image; img (P,) int32: each prompt's image
    (None for one image); tokens (P, T, 256): output + sparse tokens, both
    the initial queries and the query PE; params: `build_tail_params`.
    Returns (keys2 (P, M, 256), tokens (P, T, 256)) in the working dtype.

    CPU: the plain version.  CUDA: the kernel of the working dtype, bf16
    (`csrc/decode_tail.cu`) or float32 (`csrc/decode_tail_f32.cu`), with
    M a multiple of 64, 2 <= T <= 8, 8 heads, MLP width 2048 (an image
    index outside 0..B-1 is clamped there, since the kernel cannot raise);
    or an error."""
    _build.refuse_grad("twoway_tail", keys0, q1i, k1, v1, tokens, params)
    if keys0.device.type == "cpu":
        return twoway_tail_plain(keys0, q1i, k1, v1, tokens, params,
                                 num_heads, img)
    if keys0.device.type != "cuda":
        raise ValueError(f"twoway_tail: unsupported device {keys0.device}")
    dev, wd = keys0.device, keys0.dtype
    if wd not in (torch.bfloat16, torch.float32):
        raise TypeError(f"twoway_tail: keys0 must be bfloat16 or float32, "
                        f"got {wd}")
    if tokens.dim() != 3 or keys0.dim() not in (2, 3):
        raise ValueError("twoway_tail: keys0 (M, C) or (B, M, C) and tokens "
                         "(P, T, C)")
    (keys0, q1i, k1, v1), b = _image_rows(keys0, q1i, k1, v1, img)
    p, t, c = tokens.shape
    m = keys0.shape[1]
    if (num_heads != NUM_HEADS or c != EMBED_DIM or m == 0 or m % ROW_TILE
            or not 2 <= t <= MAX_TOKENS or p == 0):
        raise ValueError(
            f"twoway_tail: unsupported shape: {p} prompts, {t} tokens, "
            f"{m} rows, width {c}, {num_heads} heads (rows a multiple of "
            f"{ROW_TILE}, 2..{MAX_TOKENS} tokens, width {EMBED_DIM}, "
            f"{NUM_HEADS} heads)")
    cd = INTERNAL_DIM
    _check(keys0, "keys0", (b, m, c), wd, dev)
    for x, name in ((q1i, "q1i"), (k1, "k1"), (v1, "v1")):
        _check(x, name, (b, m, cd), wd, dev)
    _check(tokens, "tokens", (p, t, c), wd, dev)
    if img is not None:
        _check(img, "img", (p,), torch.int32, dev)
    mlp = params["mlp1_w"].shape[0]
    if mlp != MLP_DIM or params["mlp1l0_w"].shape[0] != mlp:
        raise ValueError(f"twoway_tail: MLP width {mlp} (the kernel takes "
                         f"{MLP_DIM}, SAM's)")
    shapes = {"kpe2": (m, cd), "qpe2i": (m, cd), "kpef": (m, cd),
              "wide2": (3 * cd, c), "widef": (2 * cd, c)}
    for name in PARAM_NAMES:
        x = params[name]
        if name in shapes:
            _check(x, name, shapes[name], wd, dev)
        elif name.endswith("_w") and x.dim() == 2:
            _check(x, name, x.shape, wd, dev)
        else:
            _check(x, name, x.shape, torch.float32, dev)
    ptrs = (ctypes.c_void_p * len(PARAM_NAMES))(
        *(params[n].data_ptr() for n in PARAM_NAMES))
    if wd == torch.float32:
        out = _launch_f32(keys0, q1i, k1, v1, tokens, params, ptrs, img, b,
                          mlp)
    else:
        out = _launch_bf16(keys0, q1i, k1, v1, tokens, ptrs, img, b, mlp)
    twoway_tail.launches += 1
    twoway_tail.launches_by_dtype[str(wd).replace("torch.", "")] += 1
    return out


def _launch_bf16(keys0, q1i, k1, v1, tokens, ptrs, img, b, mlp):
    """`csrc/decode_tail.cu` on checked bf16 operands."""
    dev, bf = keys0.device, torch.bfloat16
    p, t, c = tokens.shape
    m, cd = keys0.shape[1], INTERNAL_DIM
    nt = m // ROW_TILE
    tp, ht = MAX_TOKENS, NUM_HEADS * MAX_TOKENS
    keys2 = torch.empty((p, m, c), dtype=bf, device=dev)
    tok_out = torch.empty((p, t, c), dtype=bf, device=dev)
    # Scratch: keys1 (row phase 1 to row phase 2), the f32 token state (two
    # buffers that alternate), query heads,
    # the two updates' token keys and folded values, the split-softmax
    # partials of one attention and their merge.
    keys1 = torch.empty((p, m, c), dtype=bf, device=dev)
    tok_state = torch.empty((2, p, tp, c), dtype=torch.float32, device=dev)
    qh = torch.empty((p, tp, cd), dtype=torch.float32, device=dev)
    ktok = torch.empty((2, p, tp, cd), dtype=bf, device=dev)
    ut = torch.empty((2, p, c, ht), dtype=bf, device=dev)
    # per (prompt, head, token, tile): max, sum, 16 values of P.V, 2 pad
    part = torch.empty((p, ht, nt, 20), dtype=torch.float32, device=dev)
    att = torch.empty((p, tp, cd), dtype=torch.float32, device=dev)
    fn = _build.function("decode_tail", "twoway_tail_forward", _ARGTYPES)
    status = fn(keys0.data_ptr(), q1i.data_ptr(), k1.data_ptr(),
                v1.data_ptr(), tokens.data_ptr(),
                ctypes.cast(ptrs, ctypes.c_void_p), keys2.data_ptr(),
                keys1.data_ptr(), tok_out.data_ptr(), tok_state.data_ptr(),
                qh.data_ptr(), ktok[0].data_ptr(), ut[0].data_ptr(),
                ktok[1].data_ptr(), ut[1].data_ptr(), part.data_ptr(),
                att.data_ptr(), 0 if img is None else img.data_ptr(), p, t,
                m, b, mlp, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "twoway_tail")
    return keys2, tok_out


def _launch_f32(keys0, q1i, k1, v1, tokens, params, ptrs, img, b, mlp):
    """`csrc/decode_tail_f32.cu` on checked float32 operands, with the
    packed weights of `PACKED` and one scratch allocation (keys1 and q2i
    from row phase 1 to row phase 2, the token state, query heads, token
    keys, folded values, the MLP's partials and the row tiles' partial
    softmaxes: the source's `layout`)."""
    dev, f32 = keys0.device, torch.float32
    p, t, c = tokens.shape
    m = keys0.shape[1]
    keys2 = torch.empty((p, m, c), dtype=f32, device=dev)
    tok_out = torch.empty((p, t, c), dtype=f32, device=dev)
    packed = [tf32x3.packed(params[n], kind) for n, kind in PACKED]
    pk = (ctypes.c_void_p * len(packed))(*(x.data_ptr() for x in packed))
    size = _build.function("decode_tail_f32", "twoway_tail_f32_scratch_bytes",
                           (ctypes.c_int, ctypes.c_int),
                           restype=ctypes.c_longlong)(p, m)
    scratch = torch.empty(size, dtype=torch.uint8, device=dev)
    fn = _build.function("decode_tail_f32", "twoway_tail_f32_forward",
                         _F32_ARGTYPES)
    status = fn(keys0.data_ptr(), q1i.data_ptr(), k1.data_ptr(),
                v1.data_ptr(), tokens.data_ptr(),
                ctypes.cast(ptrs, ctypes.c_void_p),
                ctypes.cast(pk, ctypes.c_void_p), keys2.data_ptr(),
                tok_out.data_ptr(), scratch.data_ptr(),
                0 if img is None else img.data_ptr(), p, t, m, b, mlp,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "twoway_tail float32")
    return keys2, tok_out


twoway_tail.launches = 0
# Launches by working dtype ("bfloat16" for `csrc/decode_tail.cu`,
# "float32" for its float32 arm), counted with `launches`.
twoway_tail.launches_by_dtype = collections.Counter()
