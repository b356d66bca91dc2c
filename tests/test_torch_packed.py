"""The port's packed mask layout (`ops/packed.py`) against the JAX package's:
pure index work, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdsam_tpu.ops import packed as jax_packed

from crowdsam_tpu_torch.ops import packed
from crowdsam_tpu_torch.ops.amg import batched_mask_to_box

GRIDS = [(4, 4), (3, 5), (16, 16)]


@pytest.mark.parametrize("h,w", GRIDS)
def test_packed_coord_maps_equal_jax(h, w):
    xm, ym = packed.packed_coord_maps(h, w)
    xj, yj = jax_packed.packed_coord_maps(h, w)
    assert xm.dtype == torch.int32 and xm.shape == (h * w, 16)
    np.testing.assert_array_equal(xm.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(ym.numpy(), np.asarray(yj))


@pytest.mark.parametrize("h,w", GRIDS)
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_pack_unpack_equal_jax_and_invert(h, w, lead):
    x = np.random.default_rng(0).normal(size=lead + (4 * h, 4 * w)).astype(
        np.float32)
    got = packed.pack_spatial(torch.from_numpy(x))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_packed.pack_spatial(jnp.asarray(x))))
    back = packed.unpack_spatial(got, h, w)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(jax_packed.unpack_spatial(jnp.asarray(got.numpy()), h, w)))


@pytest.mark.parametrize("h,w", GRIDS)
def test_packed_flat_index_equals_jax_and_addresses_the_pixel(h, w):
    rng = np.random.default_rng(1)
    py = rng.integers(0, 4 * h, 200)
    px = rng.integers(0, 4 * w, 200)
    got = packed.packed_flat_index(torch.from_numpy(py), torch.from_numpy(px),
                                   w)
    want = jax_packed.packed_flat_index(jnp.asarray(py), jnp.asarray(px), w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    img = torch.arange(16 * h * w).reshape(4 * h, 4 * w)
    flat = packed.pack_spatial(img).reshape(-1)
    np.testing.assert_array_equal(flat[got].numpy(), img.numpy()[py, px])


@pytest.mark.parametrize("h,w", GRIDS)
def test_packed_mask_to_box_equals_jax_and_the_spatial_boxes(h, w):
    rng = np.random.default_rng(2)
    masks = rng.uniform(size=(6, 4 * h, 4 * w)) > 0.93
    masks[0] = False                                    # an empty mask
    masks[1] = False
    masks[1, 4 * h - 1, 0] = True                       # a single corner pixel
    pk = packed.pack_spatial(torch.from_numpy(masks))
    xm, ym = packed.packed_coord_maps(h, w)
    got = packed.packed_mask_to_box(pk, xm, ym, h, w)
    xj, yj = jax_packed.packed_coord_maps(h, w)
    want = jax_packed.packed_mask_to_box(jnp.asarray(pk.numpy()), xj, yj, h, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), batched_mask_to_box(torch.from_numpy(masks)).numpy())
    assert got[0].tolist() == [0, 0, 0, 0]
