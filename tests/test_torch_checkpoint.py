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


def _mixed_tree():
    rng = np.random.default_rng(0)
    return {
        "step": np.asarray(7),
        "adapter": {"k": rng.normal(size=(3, 40)).astype(np.float32),
                    "b": np.arange(300, dtype=np.int32),
                    "bf": np.asarray(jnp.ones((2, 3), jnp.bfloat16)),
                    "e": np.zeros((0, 4), np.float32)},
        "name": "x" * 40, "n": -5, "big": 70000, "f": 1.5, "none": None,
        "flag": True, "scalar": np.float32(3.0), "list": [1, 2.0, "a"],
    }


@pytest.mark.parametrize("chunk_bytes", [None, 64])
def test_writer_gives_flax_bytes(monkeypatch, chunk_bytes):
    """`dump` of a tree (numpy leaves, or torch tensors for the arrays)
    equals `flax.serialization.msgpack_serialize` byte for byte; with
    `chunk_bytes` both split the larger arrays into chunks."""
    if chunk_bytes is not None:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk_bytes)
        monkeypatch.setattr(msgpack_io, "MAX_CHUNK_SIZE", chunk_bytes)
    tree = _mixed_tree()
    want = serialization.msgpack_serialize(tree)
    assert msgpack_io.dump(tree) == want
    as_torch = dict(tree, adapter={
        "k": torch.from_numpy(tree["adapter"]["k"]),
        "b": torch.from_numpy(tree["adapter"]["b"]),
        "bf": torch.ones((2, 3), dtype=torch.bfloat16),
        "e": torch.zeros((0, 4))})
    assert msgpack_io.dump(as_torch) == want


@pytest.mark.parametrize("path", ADAPTERS, ids=lambda p: p.name)
def test_writer_round_trips_committed_adapters(path):
    """Read by the port and written again: the same file."""
    raw = path.read_bytes()
    assert msgpack_io.dump(msgpack_io.msgpack_restore(raw)) == raw


def test_save_pytree_and_port_save_read_each_other(tmp_path):
    """A tree the port saves loads with the JAX package's `load_pytree`,
    and one `save_pytree` writes loads with the port's reader."""
    from crowdsam_tpu.utils.checkpoint import load_pytree, save_pytree

    tree = {"step": np.asarray(3), "adapter": {
        "w": np.random.default_rng(1).normal(size=(4, 5)).astype(np.float32)},
        "opt_state": {"count": np.asarray(3, np.int32)}}
    msgpack_io.save(str(tmp_path / "port.msgpack"), tree)
    back = load_pytree(str(tmp_path / "port.msgpack"))
    np.testing.assert_array_equal(back["adapter"]["w"], tree["adapter"]["w"])
    assert int(back["step"]) == 3 and int(back["opt_state"]["count"]) == 3
    save_pytree(str(tmp_path / "jax.msgpack"), tree)
    got = msgpack_io.load(str(tmp_path / "jax.msgpack"))
    np.testing.assert_array_equal(got["adapter"]["w"].numpy(),
                                  tree["adapter"]["w"])
    assert (tmp_path / "jax.msgpack").read_bytes() == \
        (tmp_path / "port.msgpack").read_bytes()


def test_port_decoder_tree_loads_as_a_jax_adapter(tmp_path):
    """A decoder saved from the port's state dict (`mask_decoder_tree`)
    loads with `load_adapter_checkpoint` as the JAX package's own decoder
    tree: same structure, same values."""
    from crowdsam_tpu.models.build import build_sam_vit_tiny
    from crowdsam_tpu.utils.checkpoint import load_adapter_checkpoint
    from crowdsam_tpu.utils.checkpoint import jax_tree_to_numpy
    from crowdsam_tpu_torch.utils.weights import mask_decoder_tree

    jsam = build_sam_vit_tiny(dtype=jnp.float32, seed=1, dino_dim=64)
    want = jax_tree_to_numpy(jsam.params["mask_decoder"])
    sd = mask_decoder_state_dict(want)
    msgpack_io.save(str(tmp_path / "dec.msgpack"), mask_decoder_tree(sd))
    got = load_adapter_checkpoint(str(tmp_path / "dec.msgpack"))

    def same(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k], f"{path}/{k}")
            else:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]),
                                              err_msg=f"{path}/{k}")
    same(got, want)
