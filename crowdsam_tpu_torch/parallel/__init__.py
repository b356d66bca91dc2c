"""Batched and multi-device pipelines (torch.distributed)."""
