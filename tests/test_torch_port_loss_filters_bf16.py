"""The edge-loss filters in bf16 (`loss_filters_dtype="bfloat16"`, the
opt-in of `TrainConfig`) against the JAX package compiled with XLA's excess
precision off (`xla_allow_excess_precision`: with it on, XLA may drop the
bf16 roundings the filters declare), on the CPU, on bf16-exact inputs.

Readings: `sobel_edges_3d` and `gaussian_blur_3d` on bf16 volumes equal
JAX's bitwise (no output differs), and `mae_loss_terms`' edge term reads
1.0e-6 and 5.2e-7 relative (without and with `norm_pix_loss`), the others
under 1e-6. Gates: a share of differing filter outputs at most
MISMATCH_SHARE (an f32 sum order may flip a bf16 rounding), each loss term
within LOSS_TOL. Controls that must miss: the f32 filters against JAX's
bf16 ones (every output differs; the edge term reads 1.5e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ae_plus_plus_tpu.ops import filters as jf
from vit_ae_plus_plus_tpu.train.objective import mae_loss_terms as jax_mae_loss_terms
from vit_ae_plus_plus_torch.ops import gaussian_blur_3d, sobel_edges_3d
from vit_ae_plus_plus_torch.train import mae_loss_terms

NO_EXCESS = {"xla_allow_excess_precision": False}
MISMATCH_SHARE = 1e-3
LOSS_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_exact(shape, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).bfloat16().float().numpy()


def _no_excess(fn, *args):
    args = [jnp.asarray(a) for a in args]
    return jax.device_get(jax.jit(fn).lower(*args).compile(NO_EXCESS)(*args))


@pytest.mark.parametrize("name", ["sobel_edges_3d", "gaussian_blur_3d"])
def test_bf16_filters_match_jax_without_excess_precision(name):
    jfn, tfn = {"sobel_edges_3d": (jf.sobel_edges_3d, sobel_edges_3d),
                "gaussian_blur_3d": (lambda v: jf.gaussian_blur_3d(v, 2.0), lambda v: gaussian_blur_3d(v, 2.0))}[name]
    x = _bf16_exact((2, 2, 16, 16, 16), 0)
    want = np.asarray(_no_excess(lambda v: jfn(v.astype(jnp.bfloat16)).astype(jnp.float32), x))
    got = tfn(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert np.mean(got.float().numpy() != want) <= MISMATCH_SHARE
    assert np.mean(tfn(torch.from_numpy(x)).numpy() != want) > 0.5  # the f32 filters: the control


@pytest.mark.parametrize("norm_pix_loss", [False, True])
def test_mae_loss_terms_with_bf16_filters_match_jax(norm_pix_loss):
    p = 4
    pred, view1 = _bf16_exact((2, 64, p**3), 1), _bf16_exact((2, 1, 16, 16, 16), 2)
    mask = (np.random.default_rng(3).random((2, 64)) > 0.25).astype(np.float32)
    kw = dict(edge_map_weight=0.01, norm_pix_loss=norm_pix_loss)

    def jax_terms(pred, mask, view1):
        return jax_mae_loss_terms({"pred": pred, "mask": mask}, view1, p, filters_dtype="bfloat16", **kw)[1]

    want = _no_excess(jax_terms, pred, mask, view1)
    inputs = ({"pred": torch.from_numpy(pred), "mask": torch.from_numpy(mask)}, torch.from_numpy(view1), p)
    got = mae_loss_terms(*inputs, filters_dtype="bfloat16", **kw)[1]
    f32 = mae_loss_terms(*inputs, **kw)[1]
    assert set(got) == set(want)
    for k, w in want.items():
        assert abs(float(got[k]) - float(w)) <= LOSS_TOL * abs(float(w)), k
    edge = float(want["edge_map_loss"])
    assert abs(float(f32["edge_map_loss"]) - edge) > LOSS_TOL * edge  # the control
