"""Model export for serving.

Counterpart of the JAX package's `utils/export.py`, which exports the
prompt->mask subgraph (the reference's ONNX wrapper `SamOnnxModel`) as
serialized StableHLO through `jax.export`.  Here the same subgraph is an
`nn.Module` exported with `torch.export` and serialized with
`torch.export.save`: a server loads it with `load_exported` and runs it
without the model's Python.  Every LayerNorm on the path is the op
`crowdsam_tpu_torch::layer_norm` (`ops/layernorm.py`, registered when this
module is imported), so on CUDA the exported program launches kernel K1 and
on the CPU it runs the plain version.

The modules hold their weights (PyTorch's idiom; the JAX functions take
their params as the first argument) and have static shapes: one program
per batch, prompt count and output size, as in the JAX package.
"""

from __future__ import annotations

import io
from typing import Optional, Tuple

import torch
import torch.nn as nn

from crowdsam_tpu_torch.config import resolve_device
from crowdsam_tpu_torch.models.common import compute_dtype
from crowdsam_tpu_torch.ops import layernorm  # noqa: F401  (registers K1)
from crowdsam_tpu_torch.ops.amg import calculate_stability_score
from crowdsam_tpu_torch.ops.resize import resize_linear
from crowdsam_tpu_torch.ops.transforms import get_preprocess_shape


class DecoderFn(nn.Module):
    """forward(features (1, h, w, C), dino_proj (4h, 4w, C), point_coords
    (B, N, 2), point_labels (B, N)) -> (masks, iou, cls): the prompt encoder
    on the points and the mask decoder, the surface `SamOnnxModel` wraps."""

    def __init__(self, sam, multimask: bool = True):
        super().__init__()
        self.prompt_encoder = sam.prompt_encoder
        self.mask_decoder = sam.mask_decoder
        self.multimask = multimask

    def forward(self, features, dino_proj, point_coords, point_labels):
        sparse, dense = self.prompt_encoder(
            points=(point_coords, point_labels))
        return self.mask_decoder(features, self.prompt_encoder.get_dense_pe(),
                                 sparse, dense, self.multimask,
                                 dino_feats_proj=dino_proj)


def build_decoder_fn(sam, num_points: int = 1,
                     multimask: bool = True) -> DecoderFn:
    """The prompt-decode module of `sam` (its prompt encoder and mask
    decoder, shared); `num_points` is the JAX signature's and unused
    there too."""
    return DecoderFn(sam, multimask)


class ServingFn(nn.Module):
    """The `SamOnnxModel`-equivalent serving head (reference
    `segment_anything_cs/utils/onnx.py:16-144`), computing what the JAX
    package's `build_serving_fn` computes.

    forward(image_embeddings (1, h, w, C) NHWC, point_coords (B, N, 2),
    point_labels (B, N) float, mask_input (B, 4h, 4w, 1) NHWC,
    has_mask_input () float) -> (upscaled_masks, scores, low_res_masks), or
    (upscaled_masks, scores, stability, areas, low_res_masks) with
    `return_extra_metrics`.  Labels: 0 / 1 a negative / positive point, 2 / 3
    box corners, -1 padding.  `orig_im_size` is a static (H, W): one module
    per output size (None keeps the masks in the square `img_size`
    frame)."""

    def __init__(self, sam, return_single_mask: bool,
                 use_stability_score: bool = False,
                 return_extra_metrics: bool = False,
                 orig_im_size: Optional[Tuple[int, int]] = None,
                 stability_score_offset: float = 1.0):
        super().__init__()
        self.prompt_encoder = sam.prompt_encoder
        self.mask_decoder = sam.mask_decoder
        self.img_size = int(sam.img_size)
        self.mask_threshold = float(sam.mask_threshold)
        self.return_single_mask = return_single_mask
        self.use_stability_score = use_stability_score
        self.return_extra_metrics = return_extra_metrics
        self.orig_im_size = (None if orig_im_size is None else
                             (int(orig_im_size[0]), int(orig_im_size[1])))
        self.stability_score_offset = stability_score_offset

    def _embed_points(self, point_coords, point_labels):
        """onnx.py:51-68: the normalized PE zeroed at padding points, plus
        the learned embedding selected by the label."""
        pe_mod = self.prompt_encoder
        coords = (point_coords + 0.5) / self.img_size
        pe = pe_mod.pe_encoding(coords.float())
        lab = point_labels[..., None]
        pe = pe * (lab != -1)
        pe = pe + pe_mod.not_a_point_embed.weight[0] * (lab == -1)
        for i in range(4):
            pe = pe + pe_mod.point_embeddings[i].weight[0] * (lab == i)
        return pe

    def _postprocess(self, masks):
        """onnx.py:77-92: low-res -> img_size^2, the pad stripped to the
        pre-padded frame, -> orig_im_size."""
        up = resize_linear(masks.float(), (self.img_size, self.img_size),
                           axes=(-2, -1))
        if self.orig_im_size is not None:
            oh, ow = self.orig_im_size
            ph, pw = get_preprocess_shape(oh, ow, self.img_size)
            up = resize_linear(up[..., :ph, :pw], (oh, ow), axes=(-2, -1))
        return up

    def forward(self, image_embeddings, point_coords, point_labels,
                mask_input, has_mask_input):
        pe_mod = self.prompt_encoder
        sparse = self._embed_points(point_coords, point_labels)
        # onnx.py:70-75: the mask embedding against the no-mask embedding.
        down = pe_mod._embed_masks(mask_input).float()
        dense = has_mask_input * down + (1 - has_mask_input) * (
            pe_mod.no_mask_embed.weight.reshape(1, 1, 1, -1))
        r = self.img_size // 4
        dino_proj = torch.zeros((r, r, self.mask_decoder.transformer_dim),
                                dtype=torch.float32,
                                device=image_embeddings.device)
        masks, scores, _cls = self.mask_decoder(
            image_embeddings, pe_mod.get_dense_pe(), sparse, dense, True,
            dino_feats_proj=dino_proj)
        if self.use_stability_score:
            scores = calculate_stability_score(
                masks, self.mask_threshold,
                self.stability_score_offset).float()
        if self.return_single_mask:
            # onnx.py:95-107: token 0 boosted out of or into contention by
            # (num_points - 2.5) * 1000, without control flow.
            reweight = torch.tensor(
                [[1000.0] + [0.0] * (masks.shape[1] - 1)],
                dtype=torch.float32, device=scores.device)
            best = torch.argmax(
                scores + (point_coords.shape[1] - 2.5) * reweight, dim=1)
            b = torch.arange(masks.shape[0], device=masks.device)
            masks = masks[b, best][:, None]
            scores = scores[b, best][:, None]
        up = self._postprocess(masks)
        if self.return_extra_metrics:
            stability = calculate_stability_score(
                up, self.mask_threshold, self.stability_score_offset).float()
            areas = (up > self.mask_threshold).sum(dim=(-1, -2),
                                                   dtype=torch.int32)
            return up, scores, stability, areas, masks
        return up, scores, masks


def build_serving_fn(sam, return_single_mask: bool,
                     use_stability_score: bool = False,
                     return_extra_metrics: bool = False,
                     orig_im_size=None,
                     stability_score_offset: float = 1.0) -> ServingFn:
    """The serving head of `sam` (its prompt encoder and mask decoder,
    shared; `sam.img_size` and `sam.mask_threshold` read here)."""
    return ServingFn(sam, return_single_mask, use_stability_score,
                     return_extra_metrics, orig_im_size,
                     stability_score_offset)


def _export(module: nn.Module, device, make_args, path: str) -> bytes:
    """`torch.export` of `module` on `device` (CUDA unless named; it raises
    with no device and no CUDA) on the arguments `make_args(device, dtype)`
    gives, `dtype` the decoder's compute dtype; the program serialized to
    bytes (and to `path` if given)."""
    dev = resolve_device(device)
    module = module.to(dev).eval()
    args = make_args(dev, compute_dtype(module.mask_decoder))
    # No gradient: every LayerNorm traces as the inference op.
    with torch.no_grad():
        program = torch.export.export(module, args)
    # The zero inputs would be saved with the program (34 MB of DINO
    # projection for the decoder); a server has its own.
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def export_serving(sam, path: str = "", batch: int = 1, num_points: int = 1,
                   return_single_mask: bool = True,
                   use_stability_score: bool = False,
                   return_extra_metrics: bool = False, orig_im_size=None,
                   device=None) -> bytes:
    """Serialize the serving head (`build_serving_fn`) with `torch.export`
    on `device`; returns the bytes."""
    h, r = sam.img_size // 16, sam.img_size // 4
    fn = build_serving_fn(sam, return_single_mask, use_stability_score,
                          return_extra_metrics, orig_im_size)

    def make_args(dev, dtype):
        f32 = dict(dtype=torch.float32, device=dev)
        return (torch.zeros((1, h, h, 256), dtype=dtype, device=dev),
                torch.zeros((batch, num_points, 2), **f32),
                torch.zeros((batch, num_points), **f32),
                torch.zeros((batch, r, r, 1), **f32),
                torch.zeros((), **f32))

    return _export(fn, device, make_args, path)


def export_decoder(sam, path: str, batch: int = 32, num_points: int = 1,
                   multimask: bool = True, device=None) -> bytes:
    """Serialize the prompt-decode module (`build_decoder_fn`) with
    `torch.export` on `device` (and to `path` if given); returns the
    bytes."""
    h, r = sam.img_size // 16, sam.img_size // 4
    fn = build_decoder_fn(sam, num_points, multimask)

    def make_args(dev, dtype):
        return (torch.zeros((1, h, h, 256), dtype=dtype, device=dev),
                torch.zeros((r, r, 256), dtype=dtype, device=dev),
                torch.zeros((batch, num_points, 2), dtype=torch.float32,
                            device=dev),
                torch.ones((batch, num_points), dtype=torch.int32,
                           device=dev))

    return _export(fn, device, make_args, path)


def load_exported(path_or_bytes) -> nn.Module:
    """Deserialize a program of `export_decoder` / `export_serving` (a path
    or the bytes) and return its callable module, on the device it was
    exported on."""
    src = (path_or_bytes if isinstance(path_or_bytes, str)
           else io.BytesIO(path_or_bytes))
    return torch.export.load(src).module()
