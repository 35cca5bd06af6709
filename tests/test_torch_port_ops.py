"""The port's host ops against the JAX package: patchify, unpatchify and the
3D sincos table, on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vit_ae_plus_plus_tpu.ops import get_3d_sincos_pos_embed as jax_sincos
from vit_ae_plus_plus_tpu.ops import patchify as jax_patchify
from vit_ae_plus_plus_tpu.ops import unpatchify as jax_unpatchify
from vit_ae_plus_plus_torch.ops import get_3d_sincos_pos_embed, patchify, unpatchify


@pytest.mark.parametrize("c,s,p", [(1, 16, 4), (2, 24, 8), (4, 8, 2)])
def test_patchify_and_unpatchify_match_jax(c, s, p):
    """Pure data movement: exact equality."""
    vol = np.random.default_rng(0).standard_normal((2, c, s, s, s)).astype(np.float32)
    want = np.array(jax_patchify(jnp.asarray(vol), p))
    got = patchify(torch.from_numpy(vol), p).numpy()
    np.testing.assert_array_equal(got, want)
    back = unpatchify(torch.from_numpy(want), p).numpy()
    np.testing.assert_array_equal(back, np.asarray(jax_unpatchify(jnp.asarray(want), p)))
    np.testing.assert_array_equal(back, vol)


@pytest.mark.parametrize("dim,grid,cls", [(768, 12, True), (24, 4, False), (512, 12, True), (128, 8, True)])
def test_sincos_table_matches_jax(dim, grid, cls):
    """The same numpy arithmetic on both sides: equal to 1e-6."""
    np.testing.assert_allclose(
        get_3d_sincos_pos_embed(dim, grid, cls), jax_sincos(dim, grid, cls), rtol=0, atol=1e-6
    )


def test_patchify_rejects_non_cubic_and_indivisible():
    with pytest.raises(ValueError):
        patchify(torch.zeros(1, 1, 8, 8, 4), 4)
    with pytest.raises(ValueError):
        patchify(torch.zeros(1, 1, 10, 10, 10), 4)
