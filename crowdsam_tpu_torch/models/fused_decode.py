"""The hoisted, low-rank mask decode of the EPS engine's loop.

Counterpart of the JAX package's `models/fused_decode.py`.  Same function as
`MaskDecoder.forward` for point prompts, where the dense prompt embedding is
the shared `no_mask_embed` and so the image-side input is the same for every
prompt of an image.  Three rewrites, exact up to float reassociation:

1. Block 1's image-side projections (token->image k/v, image->token q) are
   projections of the shared input: `precompute_decode_shared` computes them
   once per image.
2. Each image->token attention adds out_proj(attn @ v_tokens) to the image
   tensor, an update of rank <= T: the out-projection is folded onto the T
   token value vectors and expanded through the attention weights.
3. proj(keys + pe) = proj(keys) + proj(pe): the constant proj(pe) terms are
   precomputed, and block 2's k, v and image-side q (and the final
   attention's k, v) become one wide product over the per-prompt image
   tensor.

The functions read the weights from the port's `MaskDecoder` and
`PromptEncoder` modules; there is no second copy of the parameters.

Two routes through `fused_decode`.  With `shared["tail"]` present (always on
CUDA) the two-way transformer is kernel K5 (`decode_tail_kernel.twoway_tail`)
and the packed mask head kernel K6 (`mask_head_kernel.mask_head`); their
wrappers launch the kernels on CUDA tensors and compute the plain versions
on CPU tensors.  Both kernels take the working dtype, bf16 or float32 (their
float32 arms), so the kernel route runs `tpu.compute_dtype float32` on the
card as well.  Without it the module-level body below runs: plain tensor
code with every head's softmax taken on its own, the reference that the
kernels' plain versions are held against.

Several images at once (the batched pipeline): `precompute_decode_shared`
over B > 1 image embeddings stacks the image-side tensors on a leading
image axis and shares the PE-side ones; `fused_decode` then takes each
prompt's image (`img`), and the DINO map one per group of prompts (the
prompts of an image are contiguous, every image sending as many).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from crowdsam_tpu_torch.models.common import gelu
from crowdsam_tpu_torch.models.decode_tail_kernel import (
    _heads,
    _merge,
    build_tail_params,
    twoway_tail,
)
from crowdsam_tpu_torch.models.mask_head_kernel import (
    build_mask_head_weights,
    mask_head,
)


def _softmax32(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=-1)


def _token_self_attn(attn, q, v, num_heads: int) -> torch.Tensor:
    """Full-width token self-attention."""
    qh = _heads(attn.q_proj(q), num_heads)
    kh = _heads(attn.k_proj(q), num_heads)
    vh = _heads(attn.v_proj(v), num_heads)
    scale = 1.0 / math.sqrt(qh.shape[-1])
    p = _softmax32((qh @ kh.transpose(-1, -2)) * scale)
    return attn.out_proj(_merge(p.to(vh.dtype) @ vh))


def _cross_t2i(attn, q_tok, kh, vh, num_heads: int) -> torch.Tensor:
    """Token->image attention against image-side heads kh, vh: (h, M, d)
    shared or (P, h, M, d)."""
    qh = _heads(attn.q_proj(q_tok), num_heads)
    scale = 1.0 / math.sqrt(qh.shape[-1])
    p = _softmax32((qh @ kh.transpose(-1, -2)) * scale)
    return attn.out_proj(_merge(p.to(vh.dtype) @ vh))


def _image_to_token_update(attn, keys, q_img_h, queries, query_pe,
                           num_heads: int) -> torch.Tensor:
    """keys + out_proj(attn(q=image, k=tokens, v=tokens)) with the
    out-projection folded onto the token value vectors (rewrite 2)."""
    k_tok = _heads(attn.k_proj(queries + query_pe), num_heads)
    v_tok = _heads(attn.v_proj(queries), num_heads)      # (P, h, T, d)
    dtype = v_tok.dtype
    scale = 1.0 / math.sqrt(q_img_h.shape[-1])
    p = _softmax32((q_img_h @ k_tok.transpose(-1, -2)) * scale).to(dtype)
    w_out = attn.out_proj.weight                          # (C, h*d)
    u = torch.einsum("phtd,chd->phtc", v_tok,
                     w_out.reshape(w_out.shape[0], num_heads, -1))
    delta = torch.einsum("phmt,phtc->pmc", p, u)
    return keys + delta + attn.out_proj.bias


@torch.no_grad()
def precompute_decode_shared(decoder, no_mask_embed: torch.Tensor,
                             image_embeddings: torch.Tensor,
                             image_pe: torch.Tensor, num_heads: int = 8,
                             kernel_route: Optional[bool] = None) -> Dict:
    """The per-image shared tensors of `fused_decode` (rewrites 1 and 3).

    decoder: the port's `MaskDecoder`; no_mask_embed (1, C); image_embeddings
    (B, h, w, C) or (h, w, C); image_pe (h, w, C).  With B > 1 the
    image-side tensors (`keys0`, the heads `k1h`, `v1h`, `q1ih` and the
    kernel's flat operands) take a leading image axis; one image keeps the
    unbatched form.  The working dtype is the decoder's Linear weights'.
    `kernel_route` adds the operands of K5 and K6, so that `fused_decode`
    goes through their wrappers; by default it follows the device: on for
    CUDA tensors, off on the CPU."""
    t = decoder.transformer
    dtype = decoder.dino_proj.weight.dtype
    h, w, c = image_embeddings.shape[-3:]
    emb = image_embeddings.reshape(-1, h, w, c)
    if emb.shape[0] == 1:
        emb = emb[0]
    keys0 = (emb.to(dtype) + no_mask_embed.reshape(1, 1, c).to(dtype))
    keys0 = keys0.reshape(*emb.shape[:-3], h * w, c)
    pe = image_pe.reshape(h * w, c).to(dtype)

    l0t2i = t.layers[0].cross_attn_token_to_image
    l0i2t = t.layers[0].cross_attn_image_to_token
    l1t2i = t.layers[1].cross_attn_token_to_image
    l1i2t = t.layers[1].cross_attn_image_to_token
    fin = t.final_attn_token_to_image

    q1i = l0i2t.q_proj(keys0 + pe)
    k1 = l0t2i.k_proj(keys0 + pe)
    v1 = l0t2i.v_proj(keys0)
    shared = {
        "keys0": keys0,
        "hw": (h, w),
        # block 1: the full image-side projections, as heads
        "k1h": _heads(k1, num_heads),
        "v1h": _heads(v1, num_heads),
        "q1ih": _heads(q1i, num_heads),
        # block 2 + final: the constant PE-side terms, biases folded in, so
        # that the per-prompt wide product carries no bias
        "kpe2": l1t2i.k_proj(pe),
        "qpe2i": l1i2t.q_proj(pe),
        "kpef": fin.k_proj(pe),
        # wide weights [out][in]: (k, v, image-side q) and (k, v)
        "wide2": torch.cat([l1t2i.k_proj.weight, l1t2i.v_proj.weight,
                            l1i2t.q_proj.weight], dim=0),
        "widef": torch.cat([fin.k_proj.weight, fin.v_proj.weight], dim=0),
        "bv2": l1t2i.v_proj.bias,
        "bvf": fin.v_proj.bias,
    }
    if kernel_route is None:
        kernel_route = keys0.device.type != "cpu"
    if kernel_route:
        shared["mask_head"] = build_mask_head_weights(decoder, dtype)
        shared["tail"] = build_tail_params(decoder, shared, dtype)
        shared["q1i_flat"] = q1i.contiguous()
        shared["k1_flat"] = k1.contiguous()
        shared["v1_flat"] = v1.contiguous()
    return shared


@torch.no_grad()
def fused_decode(decoder, shared: Dict,
                 sparse_prompt_embeddings: torch.Tensor,
                 multimask_output: bool,
                 dino_feats_proj: Optional[torch.Tensor] = None,
                 num_heads: int = 8, packed_masks: bool = False,
                 img: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (masks, iou_pred (P, K), cls (P, K, n_class)) in float32: the
    contract of `MaskDecoder.forward` for point prompts.

    sparse_prompt_embeddings (P, N, C).  With `packed_masks` false the masks
    are spatial (P, K, 4h, 4w) and `dino_feats_proj` is (4h, 4w, C); with it
    true they are packed (P, K, h*w, 16) (`ops/packed.py`) and
    `dino_feats_proj` is the packed-flat (h*w*16, C) DINO map.

    With a `shared` of B > 1 images, img (P,) int32 is each prompt's image
    and `dino_feats_proj` has a leading axis of G maps, (G, 4h, 4w, C) or
    (G, h*w*16, C): the prompts are G contiguous groups of P / G, and group
    g's prompts meet map g."""
    t = decoder.transformer
    dtype = decoder.dino_proj.weight.dtype
    p_cnt = sparse_prompt_embeddings.shape[0]
    out_tokens = torch.cat([decoder.iou_token.weight,
                            decoder.mask_tokens.weight], dim=0)
    tokens = torch.cat(
        [out_tokens[None].expand(p_cnt, -1, -1),
         sparse_prompt_embeddings.to(out_tokens.dtype)], dim=1).to(dtype)
    queries = tokens
    query_pe = tokens       # the tokens are the initial queries and the PE

    batched = shared["keys0"].dim() == 3
    if batched and img is None:
        raise ValueError("fused_decode: a shared of several images needs "
                         "each prompt's image")
    if "tail" in shared:
        keys2, queries = twoway_tail(
            shared["keys0"], shared["q1i_flat"], shared["k1_flat"],
            shared["v1_flat"], tokens.contiguous(), shared["tail"],
            num_heads=num_heads, img=img if batched else None)
        return _decode_heads(decoder, shared, queries, keys2,
                             dino_feats_proj, multimask_output, packed_masks)

    # The image-side heads of each prompt's image, (P, h, M, d).
    if batched:
        ii = img.long()
        k1h, v1h, q1ih = (shared[n][ii] for n in ("k1h", "v1h", "q1ih"))
        keys0 = shared["keys0"][ii]
    else:
        k1h, v1h, q1ih = shared["k1h"], shared["v1h"], shared["q1ih"]
        keys0 = shared["keys0"][None]
    # ---- block 1 (no PE on the first self-attention, no residual)
    l0 = t.layers[0]
    queries = l0.norm1(_token_self_attn(l0.self_attn, queries, queries,
                                        num_heads))
    att = _cross_t2i(l0.cross_attn_token_to_image, queries + query_pe,
                     k1h, v1h, num_heads)
    queries = l0.norm2(queries + att)
    queries = l0.norm3(queries + l0.mlp(queries))
    keys1 = _image_to_token_update(
        l0.cross_attn_image_to_token, keys0, q1ih, queries, query_pe,
        num_heads)
    keys1 = l0.norm4(keys1)

    # ---- block 2
    l1 = t.layers[1]
    sa = _token_self_attn(l1.self_attn, queries + query_pe, queries,
                          num_heads)
    queries = l1.norm1(queries + sa)
    cd = shared["kpe2"].shape[-1]
    kvq = keys1 @ shared["wide2"].T                       # (P, M, 3 cd)
    k2h = _heads(kvq[..., :cd] + shared["kpe2"], num_heads)
    v2h = _heads(kvq[..., cd:2 * cd] + shared["bv2"], num_heads)
    q2ih = _heads(kvq[..., 2 * cd:] + shared["qpe2i"], num_heads)
    att = _cross_t2i(l1.cross_attn_token_to_image, queries + query_pe, k2h,
                     v2h, num_heads)
    queries = l1.norm2(queries + att)
    queries = l1.norm3(queries + l1.mlp(queries))
    keys2 = _image_to_token_update(
        l1.cross_attn_image_to_token, keys1, q2ih, queries, query_pe,
        num_heads)
    keys2 = l1.norm4(keys2)

    # ---- final token -> image attention
    fin = t.final_attn_token_to_image
    kvf = keys2 @ shared["widef"].T
    kfh = _heads(kvf[..., :cd] + shared["kpef"], num_heads)
    vfh = _heads(kvf[..., cd:] + shared["bvf"], num_heads)
    att = _cross_t2i(fin, queries + query_pe, kfh, vfh, num_heads)
    queries = t.norm_final_attn(queries + att)

    return _decode_heads(decoder, shared, queries, keys2, dino_feats_proj,
                         multimask_output, packed_masks)


def _pooled_from_exp(e: torch.Tensor, mx: torch.Tensor,
                     dino_flat: torch.Tensor, dtype) -> torch.Tensor:
    """PWD pooling from the mask head's exp terms.

    e (P, K, M, 16) = exp(mask - c_j) for the row tile j of its row; mx
    (P, nblk) f32 the tile maxes c_j; dino_flat (M*16, C) packed-flat, or
    (G, M*16, C): one map per group of P / G contiguous prompts.  The
    softmax weights are exp(v - max_j c_j) / sum: the tiles are combined
    with f32 rescales exp(c_j - max), for any number of tiles.  The
    denominator is guarded: a mask that trails its tile's max (taken over
    all K masks) by more than ~88 has every term flushed to 0."""
    p_cnt, k, m, _ = e.shape
    nblk = mx.shape[1]
    x = (m // nblk) * 16                                  # elements per tile
    w = torch.exp(mx - mx.amax(dim=1, keepdim=True))      # (P, nblk) f32
    g = dino_flat.shape[0] if dino_flat.dim() == 3 else 1
    dino = dino_flat.reshape(g, m * 16, -1).to(dtype)
    ones = torch.ones((g, m * 16, 1), dtype=dtype, device=dino.device)
    daug = torch.cat([dino, ones], dim=2).reshape(g, nblk, x, -1)
    # (G, nblk, P K / G, x) against each group's own map
    e_r = e.reshape(g, p_cnt * k // g, nblk, x).transpose(1, 2)
    nd = torch.matmul(e_r, daug).float()             # (G, nblk, P K/G, C+1)
    nd = nd.transpose(0, 1).reshape(nblk, p_cnt, k, -1)
    nd = torch.einsum("jpkc,pj->pkc", nd, w)              # (P, K, C+1) f32
    num, den = nd[..., :-1], nd[..., -1:]
    return (num / den.clamp(min=1e-30)).to(dtype)


def _hyper_in(decoder, mask_tokens_out: torch.Tensor) -> torch.Tensor:
    """The K hypernetwork MLPs as 3 batched products over stacked weights:
    (P, K, C) mask tokens -> (P, K, c2)."""
    dtype = decoder.dino_proj.weight.dtype
    k_tok = decoder.num_mask_tokens
    x = mask_tokens_out.to(dtype)
    mlps = decoder.output_hypernetworks_mlps
    for layer in range(3):
        wk = torch.stack([mlps[i].layers[layer].weight for i in range(k_tok)])
        bk = torch.stack([mlps[i].layers[layer].bias for i in range(k_tok)])
        x = torch.einsum("pkc,kdc->pkd", x, wk) + bk
        if layer < 2:
            x = F.relu(x)
    return x


def _decode_heads(decoder, shared: Dict, queries: torch.Tensor,
                  keys2: torch.Tensor, dino_feats_proj, multimask_output,
                  packed_masks: bool):
    """The heads after the transformer: hypernetwork masks in one of three
    layouts (spatial, packed plain, packed through K6), IoU and class."""
    dtype = decoder.dino_proj.weight.dtype
    k_tok = decoder.num_mask_tokens
    p_cnt = queries.shape[0]
    h, w = shared["hw"]
    c = decoder.transformer_dim
    iou_token_out = queries[:, 0, :]
    mask_tokens_out = queries[:, 1:1 + k_tok, :]

    hyper_in = _hyper_in(decoder, mask_tokens_out)         # (P, K, c2)

    up_mods = decoder.output_upscaling
    pool_e = pool_mx = None
    if packed_masks and "mask_head" in shared:
        if dino_feats_proj is not None:
            masks, pool_e, pool_mx = mask_head(
                keys2.contiguous(), hyper_in.contiguous(),
                shared["mask_head"], emit_exp=True)
        else:
            masks = mask_head(keys2.contiguous(), hyper_in.contiguous(),
                              shared["mask_head"])
    elif packed_masks:
        # The depth-to-space steps stay folded into the channel axis.
        m = h * w
        up0, ln1, up3 = up_mods[0], up_mods[1], up_mods[3]
        w0 = up0.weight.permute(0, 2, 3, 1).reshape(c, -1)   # (C, 4 c1)
        up = keys2.to(dtype) @ w0 + up0.bias
        up = up.reshape(p_cnt, m, 4, -1)
        up = gelu(ln1(up))
        w2 = up3.weight.permute(0, 2, 3, 1).reshape(up3.in_channels, -1)
        up = gelu(up @ w2 + up3.bias)                        # (P, m, 4, 4 c2)
        up = up.reshape(p_cnt, m, 16, -1)
        masks = torch.einsum("pkc,pxqc->pkxq", hyper_in, up)  # (P, K, m, 16)
    else:
        src = keys2.to(dtype).reshape(p_cnt, h, w, c)
        up0, ln1, up3 = up_mods[0], up_mods[1], up_mods[3]
        up = up0(src)
        up = gelu(ln1(up))
        up = gelu(up3(up))                                   # (P, 4h, 4w, c2)
        masks = torch.einsum("pkc,pxc->pkx", hyper_in,
                             up.reshape(p_cnt, 16 * h * w, -1))
        masks = masks.reshape(p_cnt, k_tok, 4 * h, 4 * w)

    iou_pred = decoder.iou_prediction_head(iou_token_out)

    if dino_feats_proj is None:
        cls_scores = torch.zeros((p_cnt, k_tok, decoder.n_class),
                                 device=masks.device)
    elif pool_e is not None:
        pooled = _pooled_from_exp(pool_e, pool_mx, dino_feats_proj, dtype)
        cls_scores = decoder.point_classifier(pooled)
    else:
        # PWD pooling: softmax(masks) @ dino as exp weights with the
        # normalisation folded into the contraction (f32 num / den).  In
        # packed mode dino_feats_proj is packed-flat, so each weight meets
        # its own DINO element.
        npix = 16 * h * w
        mflat = masks.reshape(p_cnt, k_tok, npix).float()
        e = torch.exp(mflat - mflat.amax(dim=-1, keepdim=True)).to(dtype)
        grouped = dino_feats_proj.dim() == (3 if packed_masks else 4)
        g = dino_feats_proj.shape[0] if grouped else 1
        dino_flat = dino_feats_proj.reshape(g, npix, -1).to(dtype)
        num = (e.reshape(g, -1, npix) @ dino_flat).reshape(
            p_cnt, k_tok, -1).float()
        den = e.float().sum(dim=-1, keepdim=True)
        pooled = (num / den).to(dtype)
        cls_scores = decoder.point_classifier(pooled)

    fused = torch.cat([iou_token_out[:, None, :].expand(p_cnt, k_tok, c),
                       mask_tokens_out], dim=-1)
    iou_pred = iou_pred + decoder.parallel_iou_head(fused)[..., 0]
    sl = slice(0, None) if multimask_output else slice(0, 1)
    return (masks[:, sl].float(), iou_pred[:, sl].float(),
            cls_scores[:, sl].float())
