"""Tensor ops of the port: LayerNorm kernel, resize, boxes, NMS, cleanup."""
