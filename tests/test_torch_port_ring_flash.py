"""The port's sequence-parallel attention against the JAX package, on the CPU.

In one process:
- the plain versions of the ring's partial kernels (`attention_plain` and
  `attention_bwd_plain` with a key bias, and with fewer keys than queries)
  against `ring_flash._partial_fwd` / `_partial_bwd` run in Pallas interpret
  mode, with a partially and a fully padded block; `merge` against
  `ring_flash._merge`. Tolerance 1e-5: f32 on both sides, only the
  summation order differs.
- the dispatch without a mesh, and the ring's two refusals.

In one world of 8 spawned gloo ranks (one spawn for the module, every case
inside it; the JAX side runs in this process on its 8-device virtual mesh,
from the same numpy inputs):
- `ring_flash_attention` at the JAX tests' meshes and lengths (tests/
  test_ring_flash.py: (1, 4) x 137, (1, 4) x 65 with a fully padded block,
  (2, 2) x 137, (1, 8) x 433) and `seq_sharded_flash_attention` at (1, 4)
  and (2, 2) x 4,097, against the JAX functions: o within 2e-5, the three
  gradients within 5e-5, the JAX tests' tolerances. Head dim 32, where the
  JAX tests take 16: the port's wrappers take the kernels' head dims (32,
  64, 128) on every device.
- a tiny ViT trunk with 'flash_ring' and 'flash_seq' on a (2, 4) mesh
  (each data coordinate takes its volume, the caller's slicing) against the
  JAX 'xla' trunk on the same weights, within 2e-5.
- one tiny MAE step with 'flash_ring' on a (1, 4) mesh against the port's
  one-process 'plain' step: loss terms within 1e-5, every gradient within
  1e-4 of its largest magnitude (as tests/test_torch_port_mae.py holds the
  step to JAX), and the parameters after the step bitwise equal on the 4
  ranks.

JAX is imported inside the functions that run it: the ranks import this
module by name and need none of it.
"""

import warnings

import numpy as np
import pytest
import torch

from vit_ae_plus_plus_torch.configs import MAEConfig, ViTConfig
from vit_ae_plus_plus_torch.kernels import (
    attention_bwd_plain,
    attention_plain,
    flash_attention,
    merge,
    multihead_attention,
    reset_launch_counts,
    ring_flash_attention,
    ring_partial_fwd,
    seq_sharded_flash_attention,
)
from vit_ae_plus_plus_torch.kernels.ring_flash import NEG_INF
from vit_ae_plus_plus_torch.models import VisionTransformer3D, build_model
from vit_ae_plus_plus_torch.parallel import Mesh, get_mesh, make_mesh, run_ranks, set_mesh
from vit_ae_plus_plus_torch.train import create_train_state, make_adamw, make_train_step
from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax
from vit_ae_plus_plus_torch.train.step import feature_step

TOL = dict(rtol=1e-5, atol=1e-5)
D = 32
WORLD = 8

# ------------------------------------------------------------ one process


def _bias(nk, pad):
    bias = np.zeros(nk, np.float32)
    bias[nk - (nk if pad == "full" else nk // 3):] = NEG_INF
    return bias


@pytest.mark.parametrize("pad", ["partial", "full"])
@pytest.mark.parametrize("b,h,nq,nk,d", [(1, 1, 40, 40, 16), (2, 3, 24, 24, 32), (2, 3, 40, 24, 32)])
def test_ring_partials_plain_match_jax(b, h, nq, nk, d, pad):
    """The partial forward and backward of one ring step: the rank's nq
    query rows against an nk-key block. The backward takes the o and lse of
    each row over this block and a valid one beside it, as after the ring's
    merge, so a fully padded block's lse is finite there."""
    import jax.numpy as jnp

    from vit_ae_plus_plus_tpu.kernels.ring_flash import _partial_bwd, _partial_fwd

    rng = np.random.default_rng(nq + nk + d)
    q, do = (rng.standard_normal((b, h, nq, d)).astype(np.float32) for _ in range(2))
    k, v, k2, v2 = (rng.standard_normal((b, h, nk, d)).astype(np.float32) for _ in range(4))
    bias, scale = _bias(nk, pad), d**-0.5
    t = {name: torch.from_numpy(x) for name, x in dict(q=q, k=k, v=v, do=do, bias=bias).items()}

    o_j, lse_j = _partial_fwd(*map(jnp.asarray, (q, k, v, bias.reshape(1, 1, 1, nk))), scale, True)
    o, lse = attention_plain(t["q"], t["k"], t["v"], scale, return_lse=True, bias=t["bias"])
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :, 0], **TOL)

    both = [torch.from_numpy(np.concatenate(x, axis=2)) for x in ((k2, k), (v2, v))]
    o_row, lse_row = attention_plain(t["q"], *both, scale, return_lse=True,
                                     bias=torch.from_numpy(np.concatenate([np.zeros(nk, np.float32), bias])))
    want = _partial_bwd(*map(jnp.asarray, (q, do, o_row.numpy(), lse_row.numpy()[:, :, None], k, v,
                                           bias.reshape(1, 1, 1, nk))), scale, True)
    got = attention_bwd_plain(t["q"], t["k"], t["v"], o_row, lse_row, t["do"], scale, t["bias"])
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)
    if pad == "full":  # a block of pad keys gets no gradient and takes no weight
        assert float(got[1].abs().max()) == 0.0 and float(got[2].abs().max()) == 0.0


def test_merge_matches_jax():
    """The f32 log-sum-exp combine, a partial of a fully padded block (lse
    -1e30) among the rows: it merges with weight 0."""
    import jax.numpy as jnp

    from vit_ae_plus_plus_tpu.kernels.ring_flash import _merge

    rng = np.random.default_rng(0)
    o, o_s = (rng.standard_normal((2, 3, 40, 16)).astype(np.float32) for _ in range(2))
    lse, lse_s = (rng.standard_normal((2, 3, 40)).astype(np.float32) for _ in range(2))
    lse_s[:, :, :7] = NEG_INF
    want_o, want_lse = _merge(*map(jnp.asarray, (o, lse[:, :, None], o_s, lse_s[:, :, None])))
    got_o, got_lse = merge(*map(torch.from_numpy, (o, lse, o_s, lse_s)))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[:, :, 0], **TOL)
    np.testing.assert_array_equal(got_o.numpy()[:, :, :7], o[:, :, :7])


def _fake_mesh(model):
    """A mesh of `model` ranks that has no process group: a collective on it
    would raise."""
    return Mesh(shape={"data": 1, "model": model}, coords={"data": 0, "model": 0},
                ranks={"data": [0], "model": list(range(model))}, groups={"data": None, "model": None})


def test_dispatch_takes_flash_attention_without_a_model_group():
    """'flash_ring' and 'flash_seq' with no ambient mesh, or a 'model'
    group of one rank, are `flash_attention` (flash_attention.py:79-83 of
    the JAX package)."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 2, 37, D)).astype(np.float32)) for _ in range(3))
    want = flash_attention(q, k, v)
    reset_launch_counts()
    assert get_mesh() is None
    for impl in ("flash_ring", "flash_seq"):
        np.testing.assert_array_equal(multihead_attention(q, k, v, impl).numpy(), want.numpy())
        with set_mesh(_fake_mesh(1)):
            assert get_mesh().size("model") == 1
            np.testing.assert_array_equal(multihead_attention(q, k, v, impl).numpy(), want.numpy())
    assert get_mesh() is None
    assert ring_partial_fwd.launches == 0  # the CPU takes the plain versions


def test_ring_refusals_come_before_any_collective():
    """The JAX package's two ValueErrors, on a mesh whose collectives would
    fail: the block ceiling and the self-attention shape check."""
    big = torch.zeros(1, 1, 5000, D)  # 2 shards of 2,504 rows
    with pytest.raises(ValueError, match="more than"):
        ring_flash_attention(big, big, big, _fake_mesh(2))
    q = torch.zeros(1, 1, 8, D)
    with pytest.raises(ValueError, match="self-attention"):
        ring_flash_attention(q, q[:, :, :4], q[:, :, :4], _fake_mesh(2))
    with set_mesh(_fake_mesh(2)), pytest.raises(ValueError, match="self-attention"):
        multihead_attention(q, q[:, :, :4], q[:, :, :4], "flash_ring")


# ------------------------------------------------- the group of 8 ranks

ATTENTION = {  # case -> (impl, data, model, n)
    "ring_1x4_137": ("flash_ring", 1, 4, 137),
    "ring_1x4_65": ("flash_ring", 1, 4, 65),
    "ring_2x2_137": ("flash_ring", 2, 2, 137),
    "ring_1x8_433": ("flash_ring", 1, 8, 433),
    "seq_1x4_4097": ("flash_seq", 1, 4, 4097),
    "seq_2x2_4097": ("flash_seq", 2, 2, 4097),
}
TRUNK_CFG = dict(volume_size=16, patch_size=4, in_chans=1, embed_dim=64, depth=2, num_heads=2,
                 num_classes=0, global_pool=True)  # 65 tokens, 2 heads of 32
MAE_CFG = dict(volume_size=16, patch_size=4, embed_dim=64, depth=2, num_heads=2, decoder_embed_dim=32,
               decoder_depth=1, decoder_num_heads=1, contrastive=True)
MAE_B, EMW, CONTR_W = 2, 0.01, 0.1


def _attention_inputs(data, n):
    rng = np.random.default_rng(n + data)
    return tuple(rng.standard_normal((data, 1, n, D)).astype(np.float32) for _ in range(3))


def _weight():
    return 1 + 0.01 * np.arange(D, dtype=np.float32)


def _mae_data():
    rng = np.random.default_rng(5)
    v1, v2 = (rng.standard_normal((MAE_B, 1, 16, 16, 16)).astype(np.float32) for _ in range(2))
    return v1, v2, rng.random((2 * MAE_B, 64)).astype(np.float32)


def _mae_step(attn_impl):
    """One step of the tiny MAE from `init_weights` at seed 0 (equal in
    every process): -> metrics, the model."""
    model = build_model(MAEConfig(**MAE_CFG, attn_impl=attn_impl))
    model.init_weights(torch.Generator().manual_seed(0))
    state = create_train_state(model, make_adamw(1e-3))
    v1, v2, noise = map(torch.from_numpy, _mae_data())
    step = make_train_step(model, MAE_CFG["patch_size"], contr_weight=CONTR_W,
                           forward_fn=lambda m, a, b, _g: m(a, b, noise=noise))
    _, metrics = step(state, v1, v2, EMW)
    return {k: float(v) for k, v in metrics.items()}, model


def _run_attention(mesh, case):
    impl, data, _, n = ATTENTION[case]
    q, k, v = (torch.from_numpy(x[mesh.coords["data"]][None]).requires_grad_() for x in _attention_inputs(data, n))
    fn = ring_flash_attention if impl == "flash_ring" else seq_sharded_flash_attention
    o = fn(q, k, v, mesh)
    (o * torch.from_numpy(_weight())).sum().backward()
    return [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]


def _run_trunk(mesh, impl, tree, x):
    model = VisionTransformer3D(ViTConfig(**TRUNK_CFG, attn_impl=impl))
    model.load_state_dict(params_from_jax(tree, TRUNK_CFG["patch_size"]), strict=True)
    with set_mesh(mesh):
        return feature_step(model.eval(), torch.from_numpy(x[mesh.coords["data"]][None])).numpy()


def _run_mae(mesh):
    with set_mesh(mesh):
        metrics, model = _mae_step("flash_ring")
    named = dict(model.named_parameters())
    return (metrics, {n: p.grad.numpy() for n, p in named.items()},
            torch.cat([p.detach().flatten() for p in named.values()]).numpy())


def _group_rank(rank, tree, x):
    """One rank's program: every case on its mesh, in the same order on
    every rank (make_mesh is collective). -> {case: (data coord, result)}."""
    torch.set_num_threads(1)  # the test workers run beside the ranks
    out = {}

    def on(data, model, name, run):
        with warnings.catch_warnings(record=True) as caught:  # a mesh smaller than the world warns
            warnings.simplefilter("always")
            mesh = make_mesh(data, model)
        assert len(caught) == (data * model < WORLD), [str(w.message) for w in caught]
        if mesh is not None:
            out[name] = (mesh.coords["data"], run(mesh))

    for case, (_, data, model, _) in ATTENTION.items():
        on(data, model, case, lambda mesh: _run_attention(mesh, case))
    for impl in ("flash_ring", "flash_seq"):
        on(2, 4, f"trunk_{impl}", lambda mesh: _run_trunk(mesh, impl, tree, x))
    on(1, 4, "mae_flash_ring", _run_mae)
    return out


def _jax_trunk():
    """The JAX 'xla' ViT trunk's weights (numpy), two volumes and its
    features on them."""
    import jax
    import jax.numpy as jnp

    from vit_ae_plus_plus_tpu.configs import ViTConfig as JaxViTConfig
    from vit_ae_plus_plus_tpu.models.vit import VisionTransformer3D as JaxViT

    x = np.random.default_rng(0).standard_normal((2, 1, 16, 16, 16)).astype(np.float32)
    model = JaxViT(JaxViTConfig(**TRUNK_CFG, attn_impl="xla"))
    params = model.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x))["params"]
    want = model.apply({"params": params}, jnp.asarray(x))
    return jax.tree.map(np.asarray, params), x, np.asarray(want)


def _jax_attention(case):
    """(o, dq, dk, dv) of the JAX function on its virtual mesh."""
    import jax
    import jax.numpy as jnp

    from vit_ae_plus_plus_tpu.kernels.ring_flash import ring_flash_attention as jax_ring
    from vit_ae_plus_plus_tpu.kernels.seq_flash import seq_sharded_flash_attention as jax_seq
    from vit_ae_plus_plus_tpu.parallel import make_mesh as jax_make_mesh

    impl, data, model, n = ATTENTION[case]
    mesh = jax_make_mesh(data=data, model=model, devices=jax.devices()[: data * model])
    fn = jax_ring if impl == "flash_ring" else jax_seq

    def loss(q, k, v):
        o = fn(q, k, v, mesh)
        return jnp.sum(o * jnp.asarray(_weight())), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, _attention_inputs(data, n)))
    return [np.asarray(t) for t in (o, *grads)]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The ranks' results by case ({case: {data coord: [each model rank's
    result]}}) and the JAX references, computed while the ranks run."""
    import threading

    tree, x, want_trunk = _jax_trunk()
    results = {}
    ranks = threading.Thread(target=lambda: results.update(ranks=run_ranks(
        _group_rank, WORLD, (tree, x), store_dir=str(tmp_path_factory.mktemp("store")), timeout=600)))
    ranks.start()
    try:
        want = {case: _jax_attention(case) for case in ATTENTION}
        want["trunk"] = want_trunk
        want["mae"] = _mae_step("plain")
    finally:
        ranks.join(timeout=900)
    assert not ranks.is_alive() and "ranks" in results, "the group of ranks did not finish"
    by_case = {}
    for rank_out in results["ranks"]:
        for case, (d, result) in rank_out.items():
            by_case.setdefault(case, {}).setdefault(d, []).append(result)
    return by_case, want


@pytest.mark.parametrize("case", list(ATTENTION))
def test_sequence_parallel_attention_matches_jax(group, case):
    got, want = group[0][case], group[1][case]
    impl, data, model, n = ATTENTION[case]
    assert sorted(got) == list(range(data)) and all(len(r) == model for r in got.values())
    for d, per_rank in got.items():
        for rank_result in per_rank:  # every rank of the model group holds the whole result
            for g, w, name in zip(rank_result, want, ("o", "dq", "dk", "dv")):
                tol = 2e-5 if name == "o" else 5e-5
                np.testing.assert_allclose(g[0], w[d], rtol=tol, atol=tol, err_msg=f"{case} {name}")


@pytest.mark.parametrize("impl", ["flash_ring", "flash_seq"])
def test_vit_trunk_on_a_2x4_mesh_matches_jax(group, impl):
    got, want = group[0][f"trunk_{impl}"], group[1]["trunk"]
    assert sorted(got) == [0, 1]
    for d, per_rank in got.items():
        assert len(per_rank) == 4
        for feats in per_rank:
            np.testing.assert_allclose(feats[0], want[d], rtol=2e-5, atol=2e-5)


def test_mae_step_with_flash_ring_matches_plain_and_stays_equal_across_ranks(group):
    (per_rank,) = group[0]["mae_flash_ring"].values()
    want_metrics, plain = group[1]["mae"]
    assert len(per_rank) == 4
    for metrics, grads, _ in per_rank:
        for k, v in want_metrics.items():
            np.testing.assert_allclose(metrics[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
        for name, p in plain.named_parameters():
            w = p.grad.numpy()
            assert np.abs(grads[name] - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-30), name
    flat = [r[2] for r in per_rank]
    for other in flat[1:]:
        np.testing.assert_array_equal(other, flat[0])
