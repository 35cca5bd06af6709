"""The port's GPipe pipeline (parallel/pp.py) against the JAX package's, on
the CPU.

In this process:
- `auto_microbatches` equals JAX's over a grid of batches, stages and data
  sizes;
- `pp_param_shardings` equals JAX's `pp_state_shardings` leaf by leaf on
  the stacked state of the tiny MAE (params and AdamW moments), with and
  without `data_axis`, at three leaf-size floors; after
  `shard_pipeline_state` each rank of a (2, 2) mesh holds exactly its
  stage's blocks, each one JAX's addressable shard of that device, and its
  AdamW moments are created in that layout;
- `params_from_jax` takes JAX's `to_pp_params` tree;
- the one-stage fallback against JAX's, and a control (the blocks in the
  reverse order) that must miss;
- the divisibility errors, JAX's messages, before any collective;
- `multihead_attention(..., "flash_local")` forward and gradients against
  JAX `flash_attention_local` in Pallas interpret mode (1e-5), a control
  at another scale that must miss;
- the refusals: tensor parallelism, the sequence-parallel attention, FSDP
  without a data axis, an unlaid-out state, a mesh or resume dir of
  another S, `--n-devices` that S does not divide.

The helpers below the line run in the one world of 8 gloo ranks of
tests/test_torch_port_ring_flash.py (rank side) and in its pytest process
(the JAX side), which holds them to each other there, f32 within 1e-5 of
the largest magnitude:
- `pipelined_forward_features` and its gradients on (1, 4), (2, 2) and
  (1, 2) against JAX's, a control whose output comes from the first stage
  that must miss;
- `pipelined_mae_forward`, its gradients (every stage's blocks and the
  leaves outside the stacks, bitwise equal on every stage) and the heads'
  BatchNorm statistics, contrastive on (1, 4) and (2, 2) and not on
  (1, 2), against JAX's; controls that must miss: the output broadcast's
  gradient summed over the stages, and the input's gradient left on
  stage 0;
- two clipped AdamW steps of the stage-layout step on (2, 2) against JAX
  `make_train_step` with the pipelined forward on `to_pp_params` state
  placed by `pp_state_shardings` (what `make_pp_train_step(stacked_state=
  True)` runs, with the noise injected): metrics, parameters, moments; a
  clip norm over the stage's own leaves must miss;
- the same with FSDP composed (`data_axis='data'`), against JAX's
  composed step, each parameter within 1e-5 of the largest or four times
  JAX's own spread between its composed and pipe-only steps; a clip norm
  summed over 'data' but not 'pipe' must miss;
- `pretrain_kfold` with `pipe_devices=2` on (2, 2) (the JAX test's e2e,
  tests/test_pipeline_parallel.py:339-380) against one process's run of
  the same weights, noise and rows: losses and per-layer `.pth` within
  1e-5, features within 1e-5; a `.pth` whose stage-1 blocks sit at stage
  0's places must miss; `layout.json` `{"pipe": 2}`; a resume with
  `pipe_devices=4` refused with JAX's message.

JAX is imported inside the functions that run it: the ranks import this
module by name and need none of it.
"""

import dataclasses
import functools
import os
import shutil
from unittest import mock

import numpy as np
import pytest
import torch

from vit_ae_plus_plus_torch.configs import MAEConfig, ViTConfig
from vit_ae_plus_plus_torch.models import build_model
from vit_ae_plus_plus_torch.parallel import Mesh, mesh as transport, pp, set_mesh, tp
from vit_ae_plus_plus_torch.train import create_train_state, make_adamw, make_train_step
from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax

VOL, PATCH = 16, 4
TRUNK_CFG = dict(volume_size=VOL, patch_size=PATCH, in_chans=1, embed_dim=32, depth=4, num_heads=2,
                 num_classes=0, global_pool=True)
# the JAX tests' tiny MAE (tests/test_pipeline_parallel.py:113) with both
# stacks 4 deep, so that they split over 4 stages
PP_CFG = dict(volume_size=VOL, patch_size=PATCH, in_chans=1, embed_dim=32, depth=4, num_heads=2,
              decoder_embed_dim=24, decoder_depth=4, decoder_num_heads=4)
FEATURE_MESHES = {"1x4": (1, 4, 2), "2x2": (2, 2, 4), "1x2": (1, 2, 8)}  # (data, pipe, microbatches)
MAE_RUNS = {"contrastive_1x4": (True, 1, 4), "contrastive_2x2": (True, 2, 2), "plain_1x2": (False, 1, 2)}
MAE_B, MAE_MB = 4, 2
STEP_B = 8
LR, CLIP, EMW, CONTR_W = 1e-3, 0.05, 0.01, 0.1
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fake_mesh(data: int, pipe: int, d: int = 0, p: int = 0) -> Mesh:
    """The place (d, p) in a (data, pipe) grid, without process groups: a
    collective on it fails, so what passes ran none."""
    return Mesh(shape={"data": data, "pipe": pipe}, coords={"data": d, "pipe": p},
                ranks={"data": list(range(data)), "pipe": list(range(pipe))},
                groups={"data": None, "pipe": None})


def _mae(contrastive=True, attn_impl="plain"):
    return build_model(MAEConfig(**PP_CFG, contrastive=contrastive, attn_impl=attn_impl))


# ------------------------------------------------------------ in this process

@pytest.mark.parametrize("data", [1, 2, 3, 4])
def test_auto_microbatches_equals_jax(data):
    from vit_ae_plus_plus_tpu.parallel.pp import auto_microbatches as jax_auto

    for batch in range(1, 33):
        for stages in range(1, 9):
            assert pp.auto_microbatches(batch, stages, data) == jax_auto(batch, stages, data), (batch, stages)
    assert pp.auto_microbatches(8, 4, 1) == 8 and pp.auto_microbatches(8, 2, 2) == 4


@functools.lru_cache(maxsize=None)
def _jax_stacked_state(contrastive=True):
    """JAX's tiny MAE: its params' shapes, and the shapes of the stacked
    params and AdamW state (`to_pp_params`, `make_adamw().init`)."""
    import jax
    import jax.numpy as jnp

    from vit_ae_plus_plus_tpu.parallel.pp import to_pp_params
    from vit_ae_plus_plus_tpu.train import make_adamw as jax_adamw

    v = jnp.zeros((2, 1, VOL, VOL, VOL))
    shapes = jax.eval_shape(_jax_model(contrastive).init, {"params": jax.random.PRNGKey(1),
                                                           "mask": jax.random.PRNGKey(2)}, v, v)["params"]
    stacked = jax.eval_shape(lambda p: to_pp_params(p, PP_CFG["depth"], PP_CFG["decoder_depth"]), shapes)
    opt = jax.eval_shape(jax_adamw(LR).init, stacked)
    return shapes, stacked, opt


def _jax_model(contrastive=True):
    from vit_ae_plus_plus_tpu.configs import MAEConfig as JaxMAEConfig
    from vit_ae_plus_plus_tpu.models import build_model as jax_build

    return jax_build(JaxMAEConfig(**PP_CFG, contrastive=contrastive, attn_impl="xla"))


def _leaves(tree):
    import jax

    return [(tuple(str(getattr(k, "key", getattr(k, "name", k))) for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _trimmed(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _port_names(path, shape):
    """The port's names of a leaf of JAX's stacked tree of `shape` (one per
    layer of a stack leaf), through the weight bridge."""
    stacks = {"enc_stack": ("blocks", PP_CFG["depth"]), "dec_stack": ("decoder_blocks", PP_CFG["decoder_depth"])}
    if path[0] in stacks:
        prefix, depth = stacks[path[0]]
        return [name for i in range(depth) for name in _port_names((f"{prefix}_{i}", *path[1:]), shape[1:])]
    tree = node = {}
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = np.zeros(shape, np.float32)
    return list(params_from_jax(tree, PATCH, 1))


@pytest.mark.parametrize("min_size", [pp.MIN_SHARD_ELEMENTS, 300, 0])
@pytest.mark.parametrize("data_axis", [None, "data"])
def test_pp_placements_equal_jax_leaf_by_leaf(data_axis, min_size):
    """The port's placement of every parameter equals JAX's
    `pp_state_shardings` of its leaf in the stacked state (each layer of a
    stack leaf), and JAX's AdamW moments mirror their parameters'."""
    import jax

    from vit_ae_plus_plus_tpu.parallel.pp import make_pipeline_mesh as jax_mesh
    from vit_ae_plus_plus_tpu.parallel.pp import pp_state_shardings

    _, stacked, opt = _jax_stacked_state()
    jmesh = jax_mesh(2, data=2, devices=jax.devices()[:4])
    want_params = pp_state_shardings(stacked, jmesh, data_axis=data_axis, min_size=min_size)
    want_opt = pp_state_shardings(opt, jmesh, data_axis=data_axis, min_size=min_size)
    got = pp.pp_param_shardings(_mae(), fake_mesh(2, 2), data_axis, min_size)
    want = {}
    for (path, leaf), (_, sharding) in zip(_leaves(stacked), _leaves(want_params)):
        for name in _port_names(path, leaf.shape):
            want[name] = _trimmed(sharding.spec)
    assert got == want
    by_path = {path: _trimmed(s.spec) for path, s in _leaves(want_params)}
    moments = [(path, _trimmed(s.spec)) for path, s in _leaves(want_opt) if path[1] in ("mu", "nu")]
    assert moments and all(spec == by_path[path[2:]] for path, spec in moments)
    stacks = [s for s in got.values() if s]
    assert stacks and all(s[0] == "pipe" for s in stacks)
    assert any("data" in s for s in stacks) == (data_axis is not None and min_size < pp.MIN_SHARD_ELEMENTS)


def test_stage_blocks_equal_jax_addressable_shards():
    """Each rank of a (2, 2) mesh holds its stage's blocks only, every
    block leaf, in the JAX layout, JAX's shard on that device of the
    composed (data_axis='data', min_size 0) placement; its AdamW moments
    are created at its leaves' shapes."""
    import jax
    import jax.numpy as jnp

    from vit_ae_plus_plus_tpu.parallel.pp import make_pipeline_mesh as jax_mesh
    from vit_ae_plus_plus_tpu.parallel.pp import pp_state_shardings, to_pp_params

    shapes, _, _ = _jax_stacked_state()
    rng = np.random.default_rng(5)
    values = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    stacked = to_pp_params(jax.tree.map(jnp.asarray, values), PP_CFG["depth"], PP_CFG["decoder_depth"])
    jmesh = jax_mesh(2, data=2, devices=jax.devices()[:4])
    placed = jax.tree.map(jax.device_put, stacked, pp_state_shardings(stacked, jmesh, data_axis="data", min_size=0))
    devices = np.asarray(jmesh.devices)
    sd = params_from_jax(values, PATCH, 1)
    for d in range(2):
        for p in range(2):
            model = _mae()
            model.load_state_dict(sd, strict=False)
            state = create_train_state(model, make_adamw(LR))
            state, _ = pp.shard_pipeline_state(state, fake_mesh(2, 2, d, p), data_axis="data", min_size=0)
            named = dict(model.named_parameters())
            for stack, jstack, depth in (("blocks", "enc_stack", 4), ("decoder_blocks", "dec_stack", 4)):
                mine = range(p * depth // 2, (p + 1) * depth // 2)
                assert {int(n.split(".")[1]) for n in named if n.startswith(f"{stack}.")} == set(mine)
                assert all(isinstance(getattr(model, stack)[i], pp.RemoteBlock) for i in range(depth) if i not in mine)
                for path, arr in _leaves(placed[jstack]):
                    (shard,) = [s for s in arr.addressable_shards if s.device == devices[d, p]]
                    for j, i in enumerate(mine):
                        name = _port_names((jstack, *path), arr.shape)[i]
                        local = named[name].detach().numpy()
                        got = local.T if local.ndim == 2 else local
                        np.testing.assert_array_equal(got, np.asarray(shard.data)[j], err_msg=f"{name} at ({d}, {p})")
            for q in state.tx.params:
                q.grad = torch.zeros_like(q)
            state.tx.step()  # creates the moments; no collective without a clip
            for q in state.tx.params:
                assert state.tx.opt.state[q]["exp_avg"].shape == q.shape


def test_params_from_jax_takes_the_stacked_tree():
    import jax

    from vit_ae_plus_plus_tpu.parallel.pp import to_pp_params

    shapes, _, _ = _jax_stacked_state()
    rng = np.random.default_rng(6)
    values = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    want = params_from_jax(values, PATCH, 1)
    got = params_from_jax(jax.tree.map(np.asarray, to_pp_params(values, PP_CFG["depth"], PP_CFG["decoder_depth"])),
                          PATCH, 1)
    assert list(got) == list(want) or set(got) == set(want)
    for n, w in want.items():
        torch.testing.assert_close(got[n], w, rtol=0, atol=0)
    missing, unexpected = _mae().load_state_dict(got, strict=False)
    assert not unexpected and all(n.endswith(("running_mean", "running_var")) for n in missing)


def _jax_trunk_model():
    """The JAX 'xla' ViT trunk of tests/test_pipeline_parallel.py at depth 4."""
    from vit_ae_plus_plus_tpu.configs import ViTConfig as JaxViTConfig
    from vit_ae_plus_plus_tpu.models.vit import VisionTransformer3D as JaxViT

    return JaxViT(JaxViTConfig(**TRUNK_CFG, attn_impl="xla"))


@functools.lru_cache(maxsize=None)
def _jax_trunk(seed=1):
    """`_jax_trunk_model` and its initial weights (numpy)."""
    import jax
    import jax.numpy as jnp

    model = _jax_trunk_model()
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 1, VOL, VOL, VOL)))["params"]
    return model, jax.tree.map(np.asarray, params)


def _port_trunk(params):
    model = build_model(ViTConfig(**TRUNK_CFG, attn_impl="plain"))
    model.load_state_dict(params_from_jax(params, PATCH, 1), strict=True)
    return model


def test_one_stage_fallback_matches_jax():
    """mesh None, or one stage, runs the blocks in turn (JAX's scan), with
    the stage's attention forced local; the blocks in the reverse order
    must miss."""
    import jax
    import jax.numpy as jnp

    from vit_ae_plus_plus_tpu.parallel.pp import make_block_apply as jax_apply
    from vit_ae_plus_plus_tpu.parallel.pp import pipeline_blocks as jax_pipeline
    from vit_ae_plus_plus_tpu.parallel.pp import stack_block_params

    jmodel, params = _jax_trunk()
    h = np.random.default_rng(3).standard_normal((4, 9, 32)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jax_pipeline(jax_apply(jmodel.cfg), stack_block_params(p, 4), x, None,
                                                        n_microbatches=2))(params, jnp.asarray(h)))
    model = _port_trunk(params)
    apply = pp.make_block_apply()
    for mesh in (None, fake_mesh(2, 1)):
        got = pp.pipeline_blocks(apply, model.blocks, torch.from_numpy(h), mesh, n_microbatches=2)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=TOL * np.abs(want).max())
    reverse = pp.pipeline_blocks(apply, model.blocks[::-1], torch.from_numpy(h), None, n_microbatches=2)
    assert np.abs(reverse.detach().numpy() - want).max() > TOL * np.abs(want).max()


def test_pipeline_raises_jax_errors_before_any_collective():
    import jax
    import jax.numpy as jnp

    from vit_ae_plus_plus_tpu.parallel.pp import make_block_apply as jax_apply
    from vit_ae_plus_plus_tpu.parallel.pp import make_pipeline_mesh as jax_mesh
    from vit_ae_plus_plus_tpu.parallel.pp import pipeline_blocks as jax_pipeline
    from vit_ae_plus_plus_tpu.parallel.pp import stack_block_params

    jmodel, params = _jax_trunk()
    stacked = stack_block_params(params, 4)
    h = np.zeros((4, 9, 32), np.float32)
    jmesh = jax_mesh(4, devices=jax.devices()[:4])
    model, apply, mesh = _port_trunk(params), pp.make_block_apply(), fake_mesh(1, 4)
    cases = [("batch 4 not divisible by 3 microbatches", model.blocks, stacked, 3),
             ("depth 3 not divisible by 4 pipeline stages", model.blocks[:3],
              jax.tree.map(lambda a: a[:3], stacked), 2)]
    for message, blocks, jstacked, m in cases:
        with pytest.raises(ValueError, match=message):
            jax_pipeline(jax_apply(jmodel.cfg), jstacked, jnp.asarray(h), jmesh, n_microbatches=m)
        with pytest.raises(ValueError, match=message):
            pp.pipeline_blocks(apply, blocks, torch.from_numpy(h), mesh, n_microbatches=m)


def test_flash_local_matches_jax_interpret_mode():
    """The stages' attention route against JAX's `flash_attention_local`
    (the per-head Pallas kernels, `pallas_flash._fwd` / `_bwd`, in interpret
    mode): o and the three gradients within 1e-5; the same attention at the
    scale of another head dim must miss."""
    import jax
    import jax.numpy as jnp

    from vit_ae_plus_plus_torch.kernels import attention_plain, multihead_attention
    from vit_ae_plus_plus_tpu.kernels.pallas_flash import flash_attention_local

    rng = np.random.default_rng(4)
    q, k, v, w = (rng.standard_normal((2, 2, 65, 32)).astype(np.float32) for _ in range(4))

    def loss(q, k, v):
        o = flash_attention_local(q, k, v, interpret=True)
        return jnp.sum(o * w), o

    (_, want_o), want_g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    o = multihead_attention(tq, tk, tv, "flash_local")
    (o * torch.from_numpy(w)).sum().backward()
    for got, want in zip((o, tq.grad, tk.grad, tv.grad), (want_o, *want_g)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=TOL * max(np.abs(want).max(), 1.0))
    control = attention_plain(tq.detach(), tk.detach(), tv.detach(), 64 ** -0.5).numpy()
    assert np.abs(control - np.asarray(want_o)).max() > TOL * np.abs(want_o).max()


def test_the_pipeline_refuses_what_jax_cannot_run_either():
    mesh = fake_mesh(1, 2)
    for impl in ("flash_ring", "flash_seq"):
        with pytest.raises(ValueError, match="'model' axis"):
            pp.shard_pipeline_state(create_train_state(_mae(attn_impl=impl), make_adamw(LR)), mesh)
    state = create_train_state(_mae(), make_adamw(LR))
    state.model.blocks[0].attn.tp = True  # as tp.shard_train_state leaves it
    with pytest.raises(ValueError, match="tensor parallelism"):
        pp.shard_pipeline_state(state, mesh)
    with pytest.raises(ValueError, match=r"--fsdp with --pipe-devices needs a data axis > 1"):
        pp.shard_pipeline_state(create_train_state(_mae(), make_adamw(LR)), mesh, data_axis="data")
    with pytest.raises(ValueError, match="depth 4 not divisible by 3 pipeline stages"):
        pp.shard_pipeline_state(create_train_state(_mae(), make_adamw(LR)), fake_mesh(1, 3))
    with pytest.raises(ValueError, match="needs the stage layout"):
        pp.make_pp_train_step(_mae(), PATCH, mesh, n_microbatches=2)
    state, _ = pp.shard_pipeline_state(create_train_state(_mae(), make_adamw(LR)), mesh)
    with pytest.raises(RuntimeError, match="lives on pipeline stage 1"):
        state.model.blocks[3](torch.zeros(1, 5, 32))


def test_pretrain_kfold_and_the_cli_refuse_a_pipeline_they_cannot_run(tmp_path):
    from vit_ae_plus_plus_torch import cli
    from vit_ae_plus_plus_torch.configs import TrainConfig
    from vit_ae_plus_plus_torch.pipelines import pretrain_kfold as pk

    args = cli.build_parser().parse_args(["pretrain-kfold", "--work-dir", str(tmp_path), "--n-devices", "3",
                                          "--pipe-devices", "2"])
    with pytest.raises(ValueError, match="--n-devices 3 not divisible by --pipe-devices 2"):
        cli.world_size(args)
    assert cli.world_size(cli.build_parser().parse_args(["pretrain-kfold", "--work-dir", "w", "--pipe-devices",
                                                         "2"])) == 2
    for cfg, n, match in ((TrainConfig(pipe_devices=2, fsdp=True), 2, "needs a data axis > 1"),
                          (TrainConfig(pipe_devices=2), 3, "not divisible by --pipe-devices 2"),
                          (TrainConfig(pipe_devices=2), None, "pipeline mesh of 2 stages")):
        with pytest.raises(ValueError, match=match):
            pk.check_supported(cfg, n)
    with set_mesh(fake_mesh(2, 2)), pytest.raises(ValueError, match="'pipe' axis of 2"):
        pk.check_supported(TrainConfig(), 2)
    resume = str(tmp_path / "resume")
    pk._check_layout(resume, 2, write=True)
    pk._check_layout(resume, 2, write=True)
    with pytest.raises(ValueError, match="were written with --pipe-devices 2; this run uses --pipe-devices 4"):
        pk._check_layout(resume, 4, write=True)


# ------------------------------- the ranks' side of the 8-rank world, and JAX's

def trunk_inputs():
    """The ViT trunk's seeded weights in the JAX layout (numpy, no JAX), 8
    volumes and the loss weights of its features."""
    import chip_smoke

    cfg = ViTConfig(**TRUNK_CFG)
    params = chip_smoke.mae_encoder_tree(cfg, seed=5)
    params["fc_norm"] = params.pop("norm")
    params["pos_embed"] = (0.02 * np.random.default_rng(6).standard_normal((1, cfg.num_patches + 1, 32))
                           ).astype(np.float32)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((8, 1, VOL, VOL, VOL)).astype(np.float32)
    return params, x, rng.standard_normal((8, 32)).astype(np.float32)


def jax_features(inputs, data, pipe, n_mb):
    """JAX `pipelined_forward_features` on a (data, pipe) mesh and the
    gradients of sum(features * w) -> (features, {port name: gradient})."""
    import jax
    import jax.numpy as jnp

    from vit_ae_plus_plus_tpu.parallel.pp import make_pipeline_mesh as jax_mesh
    from vit_ae_plus_plus_tpu.parallel.pp import pipelined_forward_features

    params, x, w = inputs
    jmodel = _jax_trunk_model()
    mesh = jax_mesh(pipe, data=data, devices=jax.devices()[:data * pipe])

    def loss(p):
        f = pipelined_forward_features(jmodel, {"params": p}, jnp.asarray(x), mesh, n_microbatches=n_mb)
        return jnp.sum(f * w), f

    (_, feats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jax.tree.map(jnp.asarray, params))
    return np.asarray(feats), {n: t.numpy() for n, t in params_from_jax(jax.tree.map(np.asarray, grads),
                                                                         PATCH, 1).items()}


def control(name):
    """The controls that must miss: 'out_from_first', the pipeline's output
    broadcast from the first stage; 'out_grad_summed', the output
    broadcast's gradient summed over the stages (a psum's transpose);
    'in_grad_local', the input's gradient left on each stage (zeros but on
    stage 0); 'clip_local', the clip's norm over the stage's own leaves;
    'clip_no_pipe', the norm summed over 'data' but not over 'pipe'."""
    from vit_ae_plus_plus_torch.train import optim

    real = optim.global_norm
    if name == "out_from_first":
        real_bcast = transport.broadcast_from
        return mock.patch.object(transport, "broadcast_from", lambda t, mesh, axis, coord: real_bcast(
            t, mesh, axis, 0))
    if name == "out_grad_summed":
        return mock.patch.object(transport._FromLast, "backward", staticmethod(
            lambda ctx, g: (transport.all_reduce_sum(g, ctx.mesh, ctx.axis), None, None)))
    if name == "in_grad_local":
        return mock.patch.object(transport._FromFirst, "backward", staticmethod(lambda ctx, g: (g, None, None)))
    if name == "clip_local":
        return mock.patch.object(optim, "global_norm", lambda ts, axes=None: real(ts))
    if name == "clip_no_pipe":
        return mock.patch.object(optim, "global_norm", lambda ts, axes=None: real(
            ts, [tuple(a for a in ax if a != "pipe") for ax in axes]))
    return mock.patch.object(pp, "STACKS", pp.STACKS)  # no control: nothing changes


def _rows(mesh, b):
    d, n = mesh.coords["data"], b // mesh.size("data")
    return slice(d * n, (d + 1) * n)


def run_features(mesh, inputs, n_mb, control_name=None):
    """The port's `pipelined_forward_features` on this rank's rows of the 8
    volumes, and the gradients of sum(features * w) summed over 'data' ->
    {rows, features, grads of the leaves this rank computes}."""
    params, x, w = inputs
    model = _port_trunk(params)
    rows = _rows(mesh, 8)
    with set_mesh(mesh), control(control_name):
        feats = pp.pipelined_forward_features(model, torch.from_numpy(x[rows]), mesh, n_microbatches=n_mb)
        (feats * torch.from_numpy(w[rows])).sum().backward()
        named = [(n, p.grad) for n, p in model.named_parameters() if p.grad is not None]
        summed = transport.all_reduce_flat([g for _, g in named], mesh, "data")
    return {"rows": (rows.start, rows.stop), "features": feats.detach().numpy(),
            "grads": {n: g.numpy() for (n, _), g in zip(named, summed)}}


def mae_weights(contrastive, seed=3):
    """(params, batch_stats) of the tiny MAE, seeded numpy in the JAX layout
    (`chip_smoke.mae_tree`, no JAX)."""
    import chip_smoke

    params, stats = chip_smoke.mae_tree(MAEConfig(**PP_CFG), seed)
    if not contrastive:
        del params["heads"]
        stats = {}
    return params, stats


def mae_inputs():
    """Two views of MAE_B volumes and the masking noise of their 2B rows."""
    rng = np.random.default_rng(12)
    v1, v2 = (rng.standard_normal((MAE_B, 1, VOL, VOL, VOL)).astype(np.float32) for _ in range(2))
    return v1, v2, rng.random((2 * MAE_B, (VOL // PATCH) ** 3)).astype(np.float32)


def jax_mae(weights, contrastive, data, pipe):
    """JAX `pipelined_mae_forward` on a (data, pipe) mesh, the gradients of
    its `mae_loss_terms` total, the mutated statistics -> numpy, under the
    port's names."""
    import jax
    import jax.numpy as jnp

    from vit_ae_plus_plus_tpu.parallel.pp import make_pipeline_mesh as jax_mesh
    from vit_ae_plus_plus_tpu.parallel.pp import pipelined_mae_forward
    from vit_ae_plus_plus_tpu.train.objective import mae_loss_terms as jax_loss

    params, bs = weights
    v1, v2, noise = mae_inputs()
    jmodel = _jax_model(contrastive)
    mesh = jax_mesh(pipe, data=data, devices=jax.devices()[:data * pipe])
    noise = jnp.asarray(noise if contrastive else noise[:MAE_B])

    def loss(p):
        out, new_bs = pipelined_mae_forward(jmodel, {"params": p, "batch_stats": bs}, jnp.asarray(v1),
                                            jnp.asarray(v2) if contrastive else None, mesh=mesh,
                                            n_microbatches=MAE_MB, noise=noise, train=True)
        total, _ = jax_loss(out, jnp.asarray(v1), PATCH, edge_map_weight=EMW,
                            contr_weight=CONTR_W if contrastive else 0.0)
        return total, (out, new_bs)

    (total, (out, new_bs)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    named = params_from_jax(jax.tree.map(np.asarray, grads), PATCH, 1)
    stats = params_from_jax(jax.tree.map(np.asarray, params), PATCH, 1, jax.tree.map(np.asarray, new_bs or {}))
    return {"loss": float(total), "outputs": {k: np.asarray(v) for k, v in out.items()},
            "grads": {n: t.numpy() for n, t in named.items()},
            "stats": {n: t.numpy() for n, t in stats.items() if n.endswith(("running_mean", "running_var"))}}


def run_mae(mesh, weights, contrastive, control_name=None):
    """The port's `pipelined_mae_forward` on this rank's rows, the gradients
    of its loss averaged over 'data' -> {rows, loss, outputs, grads of the
    leaves this rank computes, statistics}."""
    from vit_ae_plus_plus_torch.train.objective import mae_loss_terms
    from vit_ae_plus_plus_torch.train.step import average_grads, data_mean

    params, bs = weights
    model = _mae(contrastive)
    model.load_state_dict(params_from_jax(params, PATCH, 1, bs), strict=True)
    model.train()
    v1, v2, noise = (torch.from_numpy(t) for t in mae_inputs())
    rows = _rows(mesh, MAE_B)
    mine = torch.cat([noise[:MAE_B][rows], noise[MAE_B:][rows]]) if contrastive else noise[:MAE_B][rows]
    with set_mesh(mesh), control(control_name):
        out = pp.pipelined_mae_forward(model, v1[rows], v2[rows] if contrastive else None, mesh=mesh,
                                       n_microbatches=MAE_MB, noise=mine)
        total, _ = mae_loss_terms(out, v1[rows], PATCH, edge_map_weight=EMW,
                                  contr_weight=CONTR_W if contrastive else 0.0)
        total.backward()
        held = [p for p in model.parameters() if p.grad is not None]
        average_grads(held)
        loss = float(data_mean({"loss": total.detach()})["loss"])
    return {"rows": (rows.start, rows.stop), "loss": loss,
            "outputs": {k: v.detach().numpy() for k, v in out.items()},
            "grads": {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None},
            "stats": {n: b.numpy().copy() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))}}


def step_weights():
    return mae_weights(True, seed=4)


def jax_steps(weights, data_axis=None, steps=2):
    """JAX `make_train_step` with the pipelined forward (what
    `make_pp_train_step(stacked_state=True)` builds) on `to_pp_params` state
    placed by `pp_state_shardings` over (2, 2), the clipped AdamW, the
    global batch's noise injected -> (each step's metrics, the parameters,
    mu, nu, statistics) per layer under the port's names."""
    import jax
    import jax.numpy as jnp

    import test_torch_port_fsdp as fs
    from vit_ae_plus_plus_tpu.parallel.pp import from_pp_params, make_pipeline_mesh as jax_mesh
    from vit_ae_plus_plus_tpu.parallel.pp import pipelined_mae_forward, pp_state_shardings, shard_pp_state
    from vit_ae_plus_plus_tpu.parallel.pp import to_pp_params
    from vit_ae_plus_plus_tpu.train import TrainState as JaxTrainState
    from vit_ae_plus_plus_tpu.train import make_adamw as jax_adamw
    from vit_ae_plus_plus_tpu.train import make_train_step as jax_train_step

    params, bs = weights
    jmodel = _jax_model(True)
    v1, v2, noise = fs.views()
    depths = (PP_CFG["depth"], PP_CFG["decoder_depth"])
    tx = jax_adamw(LR, clip_grad=CLIP)
    sp = to_pp_params(jax.tree.map(jnp.asarray, params), *depths)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=sp, batch_stats=jax.tree.map(jnp.asarray, bs),
                          opt_state=tx.init(sp), tx=tx)
    mesh = jax_mesh(2, data=2, devices=jax.devices()[:4])
    kw = dict(data_axis="data", min_size=0) if data_axis else {}
    state = shard_pp_state(state, mesh, **kw)

    def forward(variables, a, b, _rng):
        return pipelined_mae_forward(jmodel, variables, a, b, mesh=mesh, n_microbatches=2,
                                     noise=jnp.asarray(noise), train=True)

    step = jax_train_step(jmodel, PATCH, contr_weight=CONTR_W, forward_fn=forward, donate=False, mesh=mesh,
                          state_shardings=pp_state_shardings(state, mesh, **kw))
    metrics = []
    for _ in range(steps):
        state, m = step(state, jnp.asarray(v1), jnp.asarray(v2), jax.random.PRNGKey(0), jnp.float32(EMW))
        metrics.append({k: float(v) for k, v in m.items()})
    state = jax.device_get(state)
    mu, nu = fs._adam_moments(state.opt_state)
    per_layer = lambda tree: from_pp_params(tree, *depths)  # noqa: E731
    return {"metrics": metrics, "params": fs._named(per_layer(state.params)), "mu": fs._named(per_layer(mu)),
            "nu": fs._named(per_layer(nu)),
            "stats": {k: v for k, v in fs._named(per_layer(state.params), state.batch_stats).items()
                      if k.endswith(("running_mean", "running_var"))}}


def run_steps(mesh, weights, data_axis=None, control_name=None, steps=2):
    """Two clipped AdamW steps of the port's stage-layout step
    (`shard_pipeline_state`, FSDP composed with `data_axis`, leaf floor 0
    as JAX's test) on this rank's rows -> as `jax_steps` (the moments of
    this stage's leaves, whole over 'data'), and the rank's own leaves."""
    import test_torch_port_fsdp as fs

    params, bs = weights
    model = _mae(True)
    model.load_state_dict(params_from_jax(params, PATCH, 1, bs), strict=True)
    state = create_train_state(model, make_adamw(LR, clip_grad=CLIP))
    state, _ = pp.shard_pipeline_state(state, mesh, data_axis, min_size=0 if data_axis else pp.MIN_SHARD_ELEMENTS)
    v1, v2, noise = fs.views()
    rows = _rows(mesh, STEP_B)
    mine = torch.from_numpy(np.concatenate([noise[:STEP_B][rows], noise[STEP_B:][rows]]))
    step = make_train_step(model, PATCH, contr_weight=CONTR_W, forward_fn=lambda m, a, c, _g: pp.pipelined_mae_forward(
        m, a, c, mesh=mesh, n_microbatches=2, noise=mine))
    metrics = []
    with set_mesh(mesh), control(control_name):
        for _ in range(steps):
            state, m = step(state, torch.from_numpy(v1[rows]), torch.from_numpy(v2[rows]), EMW)
            metrics.append({k: float(v) for k, v in m.items()})
        whole = pp.full_state_dict(model)
        mu, nu = {}, {}
        for name, p in zip(state.tx.names, state.tx.params):
            st, dims = state.tx.opt.state[p], state.tx.placements.get(name, {})
            mu[name] = tp.whole(name, st["exp_avg"], dims, mesh).numpy().copy()
            nu[name] = tp.whole(name, st["exp_avg_sq"], dims, mesh).numpy().copy()
    return {"metrics": metrics, "params": {n: whole[n].numpy().copy() for n in whole if not n.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))}, "mu": mu, "nu": nu,
            "stats": {n: v.numpy().copy() for n, v in whole.items() if n.endswith(("running_mean", "running_var"))},
            "local": {n: p.detach().numpy().copy() for n, p in model.named_parameters()},
            "placements": model.placements}


PP_MODEL = "contr_mae_vit_tiny_pp_patch4"  # both stacks 2 deep
PP_FOLDS = 2


def pretrain_cfgs(data_dir, pipe=2, blr_scale=1):
    """The 8-rank world's BraTS split: 2 epochs of 2 steps of 4 a fold,
    with resume checkpoints."""
    from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig

    data_cfg = DataConfig(name="brats", base_path=data_dir, volume_size=VOL, in_channels=1)
    train_cfg = TrainConfig(batch_size=4, patch_size=PATCH, warmup_epochs=1, epochs=2, compute_dtype="float32",
                            contr_weight=0.001, resume=True, pipe_devices=pipe)
    return data_cfg, dataclasses.replace(train_cfg, blr=blr_scale * train_cfg.blr)


def _scipy_policy():
    from vit_ae_plus_plus_torch.data import transforms as tt
    from vit_ae_plus_plus_torch.pipelines import pretrain_kfold

    return mock.patch.object(pretrain_kfold, "default_ssl_transforms",
                             lambda: tt.default_ssl_transforms(native="never"))


def pretrain_one_process(data_dir, work):
    """One process at the (2, 2) run's rate (its data axis of 2 counts the
    global batch twice)."""
    from vit_ae_plus_plus_torch.pipelines.pretrain_kfold import pretrain_kfold

    data_cfg, train_cfg = pretrain_cfgs(data_dir, pipe=1, blr_scale=2)
    with _scipy_policy():
        return pretrain_kfold(data_cfg, train_cfg, work, model_name=PP_MODEL, n_splits=PP_FOLDS, device="cpu")


def run_pretrain(mesh, data_dir, work, refusal_mesh):
    """`pretrain_kfold` with pipe_devices=2 on the (2, 2) mesh; then, fold
    1's features set aside, a resume with pipe_devices=4 on `refusal_mesh`
    (1, 4) -> (results, the refusal's message)."""
    from vit_ae_plus_plus_torch.pipelines.pretrain_kfold import pretrain_kfold

    results, refusal = None, None
    if mesh is not None:
        data_cfg, train_cfg = pretrain_cfgs(data_dir)
        with _scipy_policy(), set_mesh(mesh):
            results = pretrain_kfold(data_cfg, train_cfg, work, model_name=PP_MODEL, n_splits=PP_FOLDS,
                                     n_devices=4, device="cpu")
            transport.mesh_barrier(mesh)
            if transport.is_writer(mesh):
                for tag in ("train", "test"):
                    name = os.path.join(work, "ssl_features_dir", f"{tag}_contrast_ssl_features_split_1.npy")
                    shutil.move(name, name + ".first")
            transport.mesh_barrier(mesh)
    if refusal_mesh is not None:
        data_cfg, train_cfg = pretrain_cfgs(data_dir, pipe=4)
        try:
            with _scipy_policy(), set_mesh(refusal_mesh):
                pretrain_kfold(data_cfg, train_cfg, work, model_name=PP_MODEL, n_splits=PP_FOLDS, n_devices=4,
                               device="cpu")
        except ValueError as e:
            refusal = str(e)
    return results, refusal
