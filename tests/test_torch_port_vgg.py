"""The port's VGG16 perceptual term (models/vgg.py) and the objective that
carries it, against the JAX package on the CPU.

JAX's `VGG16Features` params cross over through `params_from_jax` (flax
`conv_i` (kh, kw, I, O) -> `convs.i` (O, I, kh, kw)). f32 on both sides,
convolutions summed in another order: the taps within 1e-5 of each tap's
largest magnitude, the other loss terms within 1e-5 relative, the
differentiable term's gradient within 1e-5 of its largest magnitude. The
perceptual scalar, an MSE of tap differences, is within PERCEPTUAL_TOL =
5e-5 of JAX's: on these inputs the JAX package's XLA CPU convolutions put
it 1.1e-5 and 1.4e-5 (one and two channels) from the same function run in
f64, the port's f32 run under 1e-7 from it, so the port is also held to
that f64 run within 1e-6. The default (gradient-free) term leaves the
gradients of the term-free objective bitwise as they are.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ae_plus_plus_tpu.models import vgg as jvgg
from vit_ae_plus_plus_tpu.train.objective import mae_loss_terms as jax_mae_loss_terms
from vit_ae_plus_plus_torch.models import vgg as tvgg
from vit_ae_plus_plus_torch.train import mae_loss_terms
from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax

TOL = 1e-5
PERCEPTUAL_TOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vgg_pair():
    """JAX's VGG, its seeded params and its perceptual function (compiled
    once), and the port's VGG loaded with the same params."""
    model = jvgg.VGG16Features()
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 3, 32, 32)))["params"]
    params = jax.tree.map(np.asarray, params)
    port = tvgg.VGG16Features()
    port.load_state_dict(params_from_jax(params), strict=True)
    return model, params, jax.jit(jvgg.make_perceptual_fn(model, params)), port


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_vgg_taps_match_jax(vgg_pair):
    model, params, _, port = vgg_pair
    x = _np((2, 3, 32, 32), 0)
    want = model.apply({"params": params}, jnp.asarray(x))
    got = port(torch.from_numpy(x))
    assert len(got) == 4 and [t.shape[1:] for t in got] == [(64, 32, 32), (128, 16, 16), (256, 8, 8), (512, 4, 4)]
    for g, w in zip(got, want):  # flax taps are NHWC
        assert _rel(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2)) <= TOL


@pytest.mark.parametrize("channels", [1, 2])
def test_perceptual_fn_matches_jax(vgg_pair, channels):
    _, _, jax_fn, port = vgg_pair
    a, b = _np((2, channels, 8, 16, 16), 1), _np((2, channels, 8, 16, 16), 2)
    want = float(jax_fn(jnp.asarray(a), jnp.asarray(b)))
    got = float(tvgg.make_perceptual_fn(port)(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - want) <= PERCEPTUAL_TOL * abs(want), (got, want)
    f64 = copy.deepcopy(port).double()
    exact = float(tvgg.make_perceptual_fn(f64)(torch.from_numpy(a).double(), torch.from_numpy(b).double()))
    assert abs(got - exact) <= 1e-6 * exact, (got, exact)


def test_the_loader_reads_torchvision_state_dicts_as_jax_does(tmp_path):
    """A seeded torchvision-layout state dict (features.* with the pools'
    and the later layers' indices absent, a classifier entry beside them):
    the port's loader equals JAX's loader through the bridge, bitwise, and
    `build_perceptual` reads it from a file; a pickled module is refused."""
    rng = np.random.default_rng(4)
    sd, c_in = {"classifier.0.weight": rng.standard_normal((4, 4)).astype(np.float32)}, 3
    for i, c_out in zip(tvgg.TORCHVISION_CONV_INDICES, (64, 64, 128, 128, 256, 256, 256, 512, 512, 512)):
        sd[f"features.{i}.weight"] = rng.standard_normal((c_out, c_in, 3, 3)).astype(np.float32)
        sd[f"features.{i}.bias"] = rng.standard_normal(c_out).astype(np.float32)
        c_in = c_out
    want = params_from_jax(jvgg.load_torch_vgg_state_dict(sd))
    got = tvgg.load_torch_vgg_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    assert list(got) == [f"convs.{i}.{leaf}" for i in range(10) for leaf in ("weight", "bias")]
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "vgg16.pth")
    model, fn = tvgg.build_perceptual(str(tmp_path / "vgg16.pth"), device="cpu")
    assert all(torch.equal(model.state_dict()[k], want[k]) for k in want)
    torch.save(torch.nn.Linear(2, 2), tmp_path / "module.pth")
    with pytest.raises(ValueError, match="pickled module"):
        tvgg.build_perceptual(str(tmp_path / "module.pth"), device="cpu")


def test_random_weights_are_seeded_with_flax_conv_init(capsys):
    a, _ = tvgg.build_perceptual(seed=5, device="cpu")
    b, _ = tvgg.build_perceptual(seed=5, device="cpu")
    c, _ = tvgg.build_perceptual(seed=6, device="cpu")
    assert "WARNING: no VGG checkpoint given" in capsys.readouterr().out
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa) and not torch.equal(sa["convs.0.weight"], sc["convs.0.weight"])
    w = sa["convs.9.weight"]  # fan_in 4608: variance 1 / fan_in, within 2 stds of the truncated normal
    assert abs(float(w.var()) * 4608 - 1) < 0.02 and float(w.abs().max()) <= 2 / 0.8796 / 4608**0.5 + 1e-6
    assert not any(p.requires_grad for p in a.parameters())


def _outputs(c, seed):
    p, s = 4, 16
    return {"pred": _np((2, 64, p**3 * c), seed),
            "mask": (np.random.default_rng(seed + 1).random((2, 64)) > 0.25).astype(np.float32),
            **{k: _np((34, 24), seed + 2 + i) for i, k in enumerate(("p1", "p2", "z1", "z2"))}}, _np((2, c, s, s, s), 9)


@pytest.mark.parametrize("norm_pix_loss", [False, True])
def test_mae_loss_terms_with_the_perceptual_term_match_jax(vgg_pair, norm_pix_loss):
    """The term on the prediction and the (normalised, under norm_pix_loss)
    target volume, weighted into the total."""
    _, _, jax_fn, port = vgg_pair
    out, view1 = _outputs(1, 0)
    kw = dict(edge_map_weight=0.01, contr_weight=0.1, perceptual_weight=0.5, norm_pix_loss=norm_pix_loss)
    _, want = jax_mae_loss_terms({k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(view1), 4,
                                 perceptual_fn=jax_fn, **kw)
    _, got = mae_loss_terms({k: torch.from_numpy(v) for k, v in out.items()}, torch.from_numpy(view1), 4,
                            perceptual_fn=tvgg.make_perceptual_fn(port), **kw)
    assert set(got) == set(want) and float(want["perceptual_loss"]) > 0
    for k in want:
        tol = PERCEPTUAL_TOL if k in ("perceptual_loss", "loss") else TOL
        assert abs(float(got[k]) - float(want[k])) <= tol * abs(float(want[k])) + 1e-7, k


def test_the_term_is_gradient_free_unless_asked(vgg_pair):
    """Default: the gradients of the term-free objective, bitwise;
    `perceptual_differentiable=True`: the prediction's gradient against
    `jax.grad` of JAX's objective with the term differentiable."""
    _, _, jax_fn, port = vgg_pair
    out, view1 = _outputs(1, 3)
    kw = dict(edge_map_weight=0.01, contr_weight=0.1)
    fn = tvgg.make_perceptual_fn(port)

    def grad(**extra):
        pred = torch.from_numpy(out["pred"]).requires_grad_()
        outputs = {**{k: torch.from_numpy(v) for k, v in out.items()}, "pred": pred}
        total, _ = mae_loss_terms(outputs, torch.from_numpy(view1), 4, **kw, **extra)
        total.backward()
        return pred.grad

    assert torch.equal(grad(perceptual_fn=fn, perceptual_weight=0.5), grad())
    got = grad(perceptual_fn=fn, perceptual_weight=0.5, perceptual_differentiable=True)

    def jax_total(pred):
        outputs = {**{k: jnp.asarray(v) for k, v in out.items()}, "pred": pred}
        return jax_mae_loss_terms(outputs, jnp.asarray(view1), 4, perceptual_fn=jax_fn, perceptual_weight=0.5,
                                  perceptual_differentiable=True, **kw)[0]

    want = np.asarray(jax.grad(jax_total)(jnp.asarray(out["pred"])))
    assert _rel(got.numpy(), want) <= TOL
    assert _rel(got.numpy(), grad().numpy()) > 1e-3  # the term's own gradient is there
