"""Batched and (later) multi-device pipelines."""
