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

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel (ten launches on the caller's stream, see the source's
note) or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from crowdsam_tpu_torch.kernels import _build

# Kernel parameters in the order `csrc/decode_tail.cu` indexes them (enum
# Param there).  `*_w` are Linear weights (out, in) in the working dtype,
# the (M, 128) PE-side projections likewise; biases and LayerNorm
# parameters are f32.
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
    on values rounded to the working dtype `dt` where the kernel rounds."""

    def __init__(self, params: Dict[str, torch.Tensor], dt: torch.dtype):
        self.params, self.dt = params, dt

    def rnd(self, x):
        return x.to(self.dt).float()

    def par(self, name):
        return self.params[name].float()

    def dense(self, x, pfx):
        return self.rnd(self.rnd(x) @ self.par(f"{pfx}_w").T
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
    u = st.rnd(torch.einsum("phtd,chd->phtc", v_tok,
                            w_o.reshape(w_o.shape[0], num_heads, -1)))
    delta = torch.einsum("phmt,phtc->pmc", p, u)
    # The LayerNorm's input sum stays f32 (the kernel forms it twice).
    return st.rnd(st.ln32(prev + st.rnd(delta) + st.par(f"{pfx}_o_b"),
                          npfx))


def twoway_tail_plain(keys0: torch.Tensor, q1i: torch.Tensor,
                      k1: torch.Tensor, v1: torch.Tensor,
                      tokens: torch.Tensor, params: Dict[str, torch.Tensor],
                      num_heads: int = NUM_HEADS
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `twoway_tail` (same contract), in f32 with the
    kernel's rounding points; the working dtype is keys0's."""
    dt = keys0.dtype
    H = num_heads
    st = _Stages(params, dt)
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
    keys0f, q1f, k1f, v1f = (x.float() for x in (keys0, q1i, k1, v1))
    pe = tokens.to(dt).float()                         # == query_pe

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
    kvq = keys1 @ par("wide2").T                       # (P, M, 3*cd)
    k2 = rnd(kvq[..., :cd] + par("kpe2"))
    v2 = rnd(kvq[..., cd:2 * cd] + par("bv2"))
    q2i = rnd(kvq[..., 2 * cd:] + par("qpe2i"))
    qh = dense(_with_pe(queries, pe), "t2i_q")
    queries = ln(queries + cross_t2i(qh, k2, v2, "t2i"), "n2")
    mlp = dense(torch.relu(dense(queries, "mlp1")), "mlp2")
    queries = ln(queries + mlp, "n3")
    keys2 = _image_update(st, keys1, q2i, queries, pe, "i2t", "n4", H)

    # final token -> image attention
    kvf = keys2 @ par("widef").T
    kf = rnd(kvf[..., :cd] + par("kpef"))
    vf = rnd(kvf[..., cd:] + par("bvf"))
    qh = dense(_with_pe(queries, pe), "fin_q")
    queries = ln(queries + cross_t2i(qh, kf, vf, "fin"), "nf")
    return keys2.to(dt), queries.to(dt)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

_ARGTYPES = ((ctypes.c_void_p,) * 17 + (ctypes.c_int,) * 4
             + (ctypes.c_void_p,))


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    _build.require_operand("twoway_tail", t, name, shape, dtype, device)


def twoway_tail(keys0: torch.Tensor, q1i: torch.Tensor, k1: torch.Tensor,
                v1: torch.Tensor, tokens: torch.Tensor,
                params: Dict[str, torch.Tensor], num_heads: int = NUM_HEADS
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole two-way transformer for P prompts (K5).

    keys0 (M, 256): image embedding + no-mask embedding; q1i, k1, v1
    (M, 128): block 1's image-side projections, shared by the prompts;
    tokens (P, T, 256): output + sparse tokens, both the initial queries
    and the query PE; params: `build_tail_params`.  Returns (keys2
    (P, M, 256), tokens (P, T, 256)) in the working dtype.

    CPU: the plain version.  CUDA: the kernel (bf16, M a multiple of 64,
    2 <= T <= 8, 8 heads, MLP width 2048), or an error."""
    _build.refuse_grad("twoway_tail", keys0, q1i, k1, v1, tokens, params)
    if keys0.device.type == "cpu":
        return twoway_tail_plain(keys0, q1i, k1, v1, tokens, params,
                                 num_heads)
    if keys0.device.type != "cuda":
        raise ValueError(f"twoway_tail: unsupported device {keys0.device}")
    dev, bf = keys0.device, torch.bfloat16
    if tokens.dim() != 3 or keys0.dim() != 2:
        raise ValueError("twoway_tail: keys0 (M, C) and tokens (P, T, C)")
    p, t, c = tokens.shape
    m = keys0.shape[0]
    if (num_heads != NUM_HEADS or c != EMBED_DIM or m == 0 or m % ROW_TILE
            or not 2 <= t <= MAX_TOKENS or p == 0):
        raise ValueError(
            f"twoway_tail: unsupported shape: {p} prompts, {t} tokens, "
            f"{m} rows, width {c}, {num_heads} heads (rows a multiple of "
            f"{ROW_TILE}, 2..{MAX_TOKENS} tokens, width {EMBED_DIM}, "
            f"{NUM_HEADS} heads)")
    cd = INTERNAL_DIM
    _check(keys0, "keys0", (m, c), bf, dev)
    for x, name in ((q1i, "q1i"), (k1, "k1"), (v1, "v1")):
        _check(x, name, (m, cd), bf, dev)
    _check(tokens, "tokens", (p, t, c), bf, dev)
    mlp = params["mlp1_w"].shape[0]
    if mlp != MLP_DIM or params["mlp1l0_w"].shape[0] != mlp:
        raise ValueError(f"twoway_tail: MLP width {mlp} (the kernel takes "
                         f"{MLP_DIM}, SAM's)")
    shapes = {"kpe2": (m, cd), "qpe2i": (m, cd), "kpef": (m, cd),
              "wide2": (3 * cd, c), "widef": (2 * cd, c)}
    for name in PARAM_NAMES:
        x = params[name]
        if name in shapes:
            _check(x, name, shapes[name], bf, dev)
        elif name.endswith("_w") and x.dim() == 2:
            _check(x, name, x.shape, bf, dev)
        else:
            _check(x, name, x.shape, torch.float32, dev)
    ptrs = (ctypes.c_void_p * len(PARAM_NAMES))(
        *(params[n].data_ptr() for n in PARAM_NAMES))

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
                att.data_ptr(), p, t, m, mlp,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "twoway_tail")
    twoway_tail.launches += 1
    return keys2, tok_out


twoway_tail.launches = 0
