"""The port's flax msgpack reader (`crowdsam_tpu_torch/utils/msgpack_io.py`)
against `flax.serialization`, the shipped config's msgpack adapter in
`CrowdSAM`, and the model names the port does not build yet.

Bit for bit: every leaf the reader returns has flax's keys, shape and dtype
name, and the same bytes."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from crowdsam_tpu_torch.config import load_config
from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
from crowdsam_tpu_torch.utils import msgpack_io
from crowdsam_tpu_torch.utils.weights import mask_decoder_state_dict

ROOT = Path(__file__).resolve().parent.parent
ADAPTERS = sorted((ROOT / "adapter_weights").glob("*.msgpack"))


def _assert_same_tree(want, got, path=""):
    """`got` (the port's reader) equals `want` (flax's) leaf by leaf."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_tree(want[k], got[k], f"{path}/{k}")
        return
    if isinstance(want, (np.ndarray, np.generic)):
        want = np.asarray(want)
        assert isinstance(got, torch.Tensor), path
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype) == f"torch.{want.dtype.name}", path
        raw = got.reshape(-1).contiguous().view(torch.uint8).numpy()
        assert raw.tobytes() == want.tobytes(), path
        return
    assert type(got) is type(want) and got == want, path


def test_every_committed_adapter_is_found():
    assert len(ADAPTERS) >= 5


@pytest.mark.parametrize("path", ADAPTERS, ids=lambda p: p.name)
def test_reader_matches_flax_on_committed_adapters(path):
    raw = path.read_bytes()
    _assert_same_tree(serialization.msgpack_restore(raw),
                      msgpack_io.msgpack_restore(raw))


@pytest.mark.parametrize("chunk_bytes", [None, 64])
def test_reader_matches_flax_on_a_mixed_tree(monkeypatch, chunk_bytes):
    """bf16, float, int and bool arrays, numpy scalars (ext 3), empty and
    0-d arrays, python scalars, strings and nil; with `chunk_bytes` flax
    splits the larger arrays into chunks, which the reader joins."""
    if chunk_bytes is not None:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk_bytes)
    rng = np.random.default_rng(0)
    tree = {
        "layer": {
            "kernel": rng.standard_normal((5, 7)).astype(np.float32),
            "bias_bf16": np.asarray(rng.standard_normal(9), jnp.bfloat16),
            "count": np.arange(-20, 20, dtype=np.int32).reshape(4, 10),
            "steps": np.arange(3, dtype=np.int64) * (1 << 40),
            "mask": rng.random(11) > 0.5,
            "bytes": np.arange(200, dtype=np.uint8),
            "half": rng.standard_normal(6).astype(np.float16),
            "wide": rng.standard_normal((2, 3)),
        },
        "scalars": {"lr": np.float32(2e-4), "step": np.int64(800),
                    "zero_d": np.asarray(1.5, np.float32),
                    "empty": np.zeros((0, 4), np.float32)},
        "meta": {"name": "adapter", "shots": 10, "neg": -3, "big": 1 << 40,
                 "ratio": 0.341, "flag": True, "none": None},
    }
    raw = serialization.msgpack_serialize(tree)
    _assert_same_tree(serialization.msgpack_restore(raw),
                      msgpack_io.msgpack_restore(raw))


def test_reader_refuses_truncated_input():
    raw = ADAPTERS[0].read_bytes()
    with pytest.raises(ValueError, match="truncated"):
        msgpack_io.msgpack_restore(raw[: len(raw) // 2])


def test_crowdhuman_config_builds_with_its_msgpack_adapter():
    """`configs/crowdhuman.yaml` as shipped (its adapter path relative to
    the repository root) builds on the CPU, and the mask decoder holds the
    adapter's values: each parameter the adapter names equals the flax tree
    mapped through the weight bridge, in the parameter's dtype."""
    cfg = load_config(str(ROOT / "configs" / "crowdhuman.yaml"))
    adapter = cfg["model"]["sam_adapter_checkpoint"]
    assert adapter.endswith(".msgpack")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(ROOT)
        model = CrowdSAM(cfg, device="cpu")
        tree = serialization.msgpack_restore(Path(adapter).read_bytes())
    want = mask_decoder_state_dict(tree)
    got = model.sam.mask_decoder.state_dict()
    assert set(want) <= set(got)
    for key, value in want.items():
        assert torch.equal(got[key], value.to(got[key].dtype)), key


@pytest.mark.parametrize("key,name", [
    ("sam_model", "vit_h"), ("sam_model", "default"), ("sam_model", "vit_t"),
    ("dino_model", "dinov2_vitb14")])
def test_unported_model_names_name_their_slice(key, name):
    cfg = load_config(None)
    cfg["model"][key] = name
    with pytest.raises(NotImplementedError, match=r"item 5"):
        CrowdSAM(cfg, device="cpu")
