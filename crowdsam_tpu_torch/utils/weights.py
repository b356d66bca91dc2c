"""Weight bridge: the JAX package's parameter trees -> this package's state
dicts.

The JAX package converts torch checkpoints with `convert_image_encoder`,
`convert_prompt_encoder`, `convert_mask_decoder` and `convert_dinov2`
(`crowdsam_tpu/utils/checkpoint.py`); these functions are their inverses, so
one set of weights drives both packages.  They take nested dicts of numpy
arrays (a JAX tree after `jax_tree_to_numpy`) and return {key: tensor}:

- Dense kernel (in, out) -> Linear weight (out, in);
- Conv kernel (kh, kw, in, out) -> Conv2d weight (out, in, kh, kw);
- ConvTranspose2x2 dense kernel (in, 4*out) and bias (4*out,) ->
  ConvTranspose2d weight (in, out, 2, 2) and the port's per-sub-pixel bias
  (4*out,);
- LayerNorm weight/bias, embeddings and tables unchanged.

`mask_decoder_tree` goes the other way for the mask decoder, so that a
decoder the port trains is saved as the JAX package saves one.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

Tree = Dict[str, Any]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _lin(sd, key: str, p: Tree) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _conv(sd, key: str, p: Tree) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _convT2x2(sd, key: str, p: Tree) -> None:
    kernel = np.asarray(p["dense"]["kernel"])
    cin, cout = kernel.shape[0], kernel.shape[1] // 4
    sd[f"{key}.weight"] = _t(kernel.reshape(cin, 2, 2, cout)
                             .transpose(0, 3, 1, 2))
    # One bias per (sub-pixel, channel), 4*cout.  The JAX converter tiles a
    # torch (cout,) bias 4x, so a port state dict it converts comes back
    # tiled again: its first 4*cout values are the port's.
    sd[f"{key}.bias"] = _t(np.asarray(p["dense"]["bias"])[:4 * cout])


def _ln(sd, key: str, p: Tree) -> None:
    sd[f"{key}.weight"] = _t(p["weight"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _mlp(sd, key: str, p: Tree) -> None:
    i = 0
    while f"layers_{i}" in p:
        _lin(sd, f"{key}.layers.{i}", p[f"layers_{i}"])
        i += 1


def image_encoder_state_dict(p: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, f"{prefix}patch_embed.proj", p["patch_embed"])
    sd[f"{prefix}pos_embed"] = _t(p["pos_embed"])
    i = 0
    while f"blocks_{i}" in p:
        b, k = p[f"blocks_{i}"], f"{prefix}blocks.{i}"
        _ln(sd, f"{k}.norm1", b["norm1"])
        _lin(sd, f"{k}.attn.qkv", b["attn"]["qkv"])
        _lin(sd, f"{k}.attn.proj", b["attn"]["proj"])
        sd[f"{k}.attn.rel_pos_h"] = _t(b["attn"]["rel_pos_h"])
        sd[f"{k}.attn.rel_pos_w"] = _t(b["attn"]["rel_pos_w"])
        _ln(sd, f"{k}.norm2", b["norm2"])
        _lin(sd, f"{k}.mlp.lin1", b["mlp"]["lin1"])
        _lin(sd, f"{k}.mlp.lin2", b["mlp"]["lin2"])
        i += 1
    _conv(sd, f"{prefix}neck.0", p["neck_0"])
    _ln(sd, f"{prefix}neck.1", p["neck_1"])
    _conv(sd, f"{prefix}neck.2", p["neck_2"])
    _ln(sd, f"{prefix}neck.3", p["neck_3"])
    return sd


def prompt_encoder_state_dict(p: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {
        f"{prefix}pe_layer.positional_encoding_gaussian_matrix":
            _t(p["pe_gaussian"]),
        f"{prefix}not_a_point_embed.weight": _t(p["not_a_point_embed"]),
        f"{prefix}no_mask_embed.weight": _t(p["no_mask_embed"]),
    }
    pts = np.asarray(p["point_embeddings"])
    for i in range(pts.shape[0]):
        sd[f"{prefix}point_embeddings.{i}.weight"] = _t(pts[i:i + 1])
    for i in (0, 3, 6):
        _conv(sd, f"{prefix}mask_downscaling.{i}", p[f"mask_down_{i}"])
    for i in (1, 4):
        _ln(sd, f"{prefix}mask_downscaling.{i}", p[f"mask_down_{i}"])
    return sd


def _twoway_attention(sd, key: str, p: Tree) -> None:
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _lin(sd, f"{key}.{name}", p[name])


def mask_decoder_state_dict(p: Tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {
        f"{prefix}iou_token.weight": _t(p["iou_token"]),
        f"{prefix}mask_tokens.weight": _t(p["mask_tokens"]),
    }
    t = p["transformer"]
    i = 0
    while f"layers_{i}" in t:
        layer, k = t[f"layers_{i}"], f"{prefix}transformer.layers.{i}"
        for name in ("self_attn", "cross_attn_token_to_image",
                     "cross_attn_image_to_token"):
            _twoway_attention(sd, f"{k}.{name}", layer[name])
        for name in ("norm1", "norm2", "norm3", "norm4"):
            _ln(sd, f"{k}.{name}", layer[name])
        _lin(sd, f"{k}.mlp.lin1", layer["mlp"]["lin1"])
        _lin(sd, f"{k}.mlp.lin2", layer["mlp"]["lin2"])
        i += 1
    _twoway_attention(sd, f"{prefix}transformer.final_attn_token_to_image",
                      t["final_attn_token_to_image"])
    _ln(sd, f"{prefix}transformer.norm_final_attn", t["norm_final_attn"])
    _convT2x2(sd, f"{prefix}output_upscaling.0", p["upscale_0"])
    _ln(sd, f"{prefix}output_upscaling.1", p["upscale_1"])
    _convT2x2(sd, f"{prefix}output_upscaling.3", p["upscale_3"])
    i = 0
    while f"hyper_mlps_{i}" in p:
        _mlp(sd, f"{prefix}output_hypernetworks_mlps.{i}", p[f"hyper_mlps_{i}"])
        i += 1
    _mlp(sd, f"{prefix}iou_prediction_head", p["iou_prediction_head"])
    _lin(sd, f"{prefix}dino_proj", p["dino_proj"])
    _mlp(sd, f"{prefix}parallel_iou_head", p["parallel_iou_head"])
    _mlp(sd, f"{prefix}point_classifier", p["point_classifier"])
    return sd


def sam_state_dict_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """{'image_encoder', 'prompt_encoder', 'mask_decoder'} JAX tree -> `Sam`
    state dict."""
    sd = image_encoder_state_dict(params["image_encoder"], "image_encoder.")
    sd.update(prompt_encoder_state_dict(params["prompt_encoder"],
                                        "prompt_encoder."))
    sd.update(mask_decoder_state_dict(params["mask_decoder"],
                                      "mask_decoder."))
    return sd


def dino_state_dict_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """JAX DinoVisionTransformer tree -> `DinoVisionTransformer` state dict."""
    sd: Dict[str, torch.Tensor] = {
        "cls_token": _t(params["cls_token"]),
        "pos_embed": _t(params["pos_embed"]),
    }
    _conv(sd, "patch_embed.proj", params["patch_embed"])
    _ln(sd, "norm", params["norm"])
    i = 0
    while f"blocks_{i}" in params:
        b, k = params[f"blocks_{i}"], f"blocks.{i}"
        _ln(sd, f"{k}.norm1", b["norm1"])
        _lin(sd, f"{k}.attn.qkv", b["attn"]["qkv"])
        _lin(sd, f"{k}.attn.proj", b["attn"]["proj"])
        sd[f"{k}.ls1.gamma"] = _t(b["ls1_gamma"])
        _ln(sd, f"{k}.norm2", b["norm2"])
        _lin(sd, f"{k}.mlp.fc1", b["mlp_fc1"])
        _lin(sd, f"{k}.mlp.fc2", b["mlp_fc2"])
        sd[f"{k}.ls2.gamma"] = _t(b["ls2_gamma"])
        i += 1
    return sd


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def mask_decoder_tree(sd: Dict[str, torch.Tensor], prefix: str = "") -> Tree:
    """The inverse of `mask_decoder_state_dict`: a `MaskDecoder` state dict
    -> the JAX package's mask-decoder tree of float32 numpy arrays (without
    the unused 5th hypernetwork MLP, which the JAX tree does not have)."""
    def lin(key):
        out = {"kernel": _np(sd[f"{prefix}{key}.weight"]).T.copy()}
        if f"{prefix}{key}.bias" in sd:
            out["bias"] = _np(sd[f"{prefix}{key}.bias"])
        return out

    def ln(key):
        return {"weight": _np(sd[f"{prefix}{key}.weight"]),
                "bias": _np(sd[f"{prefix}{key}.bias"])}

    def mlp(key):
        out, i = {}, 0
        while f"{prefix}{key}.layers.{i}.weight" in sd:
            out[f"layers_{i}"] = lin(f"{key}.layers.{i}")
            i += 1
        return out

    def convT(key):
        w = _np(sd[f"{prefix}{key}.weight"])               # (in, out, 2, 2)
        return {"dense": {
            "kernel": w.transpose(0, 2, 3, 1).reshape(w.shape[0], -1).copy(),
            "bias": _np(sd[f"{prefix}{key}.bias"])}}

    def attn(key):
        return {n: lin(f"{key}.{n}")
                for n in ("q_proj", "k_proj", "v_proj", "out_proj")}

    t, i = {}, 0
    while f"{prefix}transformer.layers.{i}.norm1.weight" in sd:
        k = f"transformer.layers.{i}"
        layer = {n: attn(f"{k}.{n}") for n in (
            "self_attn", "cross_attn_token_to_image",
            "cross_attn_image_to_token")}
        layer.update({n: ln(f"{k}.{n}")
                      for n in ("norm1", "norm2", "norm3", "norm4")})
        layer["mlp"] = {"lin1": lin(f"{k}.mlp.lin1"),
                        "lin2": lin(f"{k}.mlp.lin2")}
        t[f"layers_{i}"] = layer
        i += 1
    t["final_attn_token_to_image"] = attn(
        "transformer.final_attn_token_to_image")
    t["norm_final_attn"] = ln("transformer.norm_final_attn")
    n_tok = sd[f"{prefix}mask_tokens.weight"].shape[0]
    tree: Tree = {
        "iou_token": _np(sd[f"{prefix}iou_token.weight"]),
        "mask_tokens": _np(sd[f"{prefix}mask_tokens.weight"]),
        "transformer": t,
        "upscale_0": convT("output_upscaling.0"),
        "upscale_1": ln("output_upscaling.1"),
        "upscale_3": convT("output_upscaling.3"),
        "iou_prediction_head": mlp("iou_prediction_head"),
        "dino_proj": lin("dino_proj"),
        "parallel_iou_head": mlp("parallel_iou_head"),
        "point_classifier": mlp("point_classifier"),
    }
    for i in range(n_tok):
        tree[f"hyper_mlps_{i}"] = mlp(f"output_hypernetworks_mlps.{i}")
    return tree
