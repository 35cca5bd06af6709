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
- data parallelism on (2, 1) and (4, 1) meshes, each rank on its rows of a
  global batch of 8: the tiny contrastive MAE's step against JAX
  `make_train_step(..., mesh=make_mesh(data=D))` on the same weights and
  global noise (loss terms 1e-5 relative, every gradient 1e-4 of its
  largest magnitude, `batch_stats` 1e-6: tests/test_torch_port_mae.py's
  f32 limits), the parameters bitwise equal across ranks, and a control
  with the BatchNorm moments left local that must miss; the step with the
  masking noise drawn from the state's generator against the port's
  one-process step on the global batch; the supervised step with unequal
  class weights on the ranks, plain and with timm's mixup (JAX's lambda
  injected), against JAX `make_supervised_steps(..., mesh=...)` (loss 1e-5
  relative, each parameter's update 1e-4 of its largest), and a control
  whose `weighted_ce` divides by each rank's own weights, which must miss;
  `pretrain_kfold` on 2 ranks, then resumed, and `extract_ssl_features` on
  2 ranks, against one process's files (the one process at twice the
  base rate: on D ranks the learning rate counts the global batch D
  times); its logged `train_lr` against the JAX package's
  `pretrain_one_fold` under a (2, 1) mesh without `lr`, within 1e-6.
- the augmentation on the card under a (2, 1) mesh: each rank's views of
  its rows equal one process's views of the global batch bitwise (the
  draws are the global batch's), and a control that draws for the rank's
  rows alone must miss.
- the MoCo step (both trunks, f64, on (2, 1) and (4, 1)) and the
  contrastive step (f64, (2, 1)) against JAX's data-mesh steps, their
  controls, and `moco_kfold` on 2 ranks with its resume against one
  process's run: tests/test_torch_port_moco_ddp.py holds the cases'
  helpers and says what each checks.
- the sharded training state: the FSDP MAE step on (8, 1) (plain, with
  the clip, with accumulation) and the MoCo ViT FSDP step on (4, 1)
  against JAX's FSDP steps, TP on (2, 4), FSDP with TP on (4, 2) and the
  'flash_ring' step on (2, 4) against JAX's, their controls, the
  transport's log, and `pretrain-kfold --fsdp` / `moco-kfold --fsdp`
  through the CLI on 2 ranks with resumes across layouts:
  tests/test_torch_port_fsdp.py holds the cases' helpers and says what
  each checks.
- the GPipe pipeline on ('data', 'pipe') meshes: the pipelined features
  on (1, 4), (2, 2) and (1, 2) and the pipelined MAE forward, gradients
  and statistics (contrastive and not) against JAX's pipelined functions,
  two clipped AdamW steps of the stage-layout step, alone and with FSDP
  composed, on (2, 2) against JAX's, their controls, and `pretrain_kfold`
  with `pipe_devices=2` on (2, 2) against one process's run, then a resume
  with another S refused: tests/test_torch_port_pp.py holds the cases'
  helpers and says what each checks.
- the serving mesh: the feature, int8 and classifier engines on (2, 1),
  (4, 1) and (8, 1) against JAX's mesh engines and the port's one-process
  engines, with a control; the MoCo (both trunks) and contrastive steps on
  (2, 2) and (2, 4) against JAX's steps on those meshes, with controls
  that reduce over the whole mesh instead of 'data', and the MoCo ViT FSDP
  step on (2, 2): tests/test_torch_port_serving_mesh.py holds the cases'
  helpers and says what each checks.

JAX is imported inside the functions that run it: the ranks import this
module by name and need none of it.
"""

import contextlib
import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

from vit_ae_plus_plus_torch.configs import DataConfig, MAEConfig, TrainConfig, ViTConfig
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
from vit_ae_plus_plus_torch.models import MODEL_ZOO, VisionTransformer3D, build_model
from vit_ae_plus_plus_torch.parallel import (
    Mesh,
    barrier,
    get_mesh,
    make_mesh,
    make_pipeline_mesh,
    run_ranks,
    set_mesh,
)
from vit_ae_plus_plus_torch.train import create_train_state, make_adamw, make_train_step
from vit_ae_plus_plus_torch.train.checkpoint import load_reference_state_dict, params_from_jax
from vit_ae_plus_plus_torch.train.optim import make_sgd
from vit_ae_plus_plus_torch.train.step import feature_step

import test_torch_port_fsdp as fs
import test_torch_port_moco_ddp as md
import test_torch_port_pp as ppt
import test_torch_port_serving_mesh as sm

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


def _group_rank(rank, tree, x, ddp):
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
    for data in DDP_MESHES:
        on(data, 1, f"ddp_mae_{data}", lambda mesh: _run_ddp_mae(mesh, ddp["mae"]))
    on(4, 1, "ddp_mae_local_moments", lambda mesh: _run_ddp_mae(mesh, ddp["mae"], local_moments=True))
    on(2, 1, "ddp_mae_generator", lambda mesh: _run_ddp_mae(mesh, ddp["mae"], noise=False))
    for case in SUPERVISED:
        on(4, 1, f"ddp_{case}", lambda mesh: _run_ddp_supervised(mesh, case, ddp["vit"], ddp["lam"]))
    on(2, 1, "ddp_pipelines", lambda mesh: _run_ddp_pipelines(mesh, ddp["dirs"]))
    for control in (False, True):
        on(2, 1, f"ddp_augment_{control}", lambda mesh: _run_ddp_augment(mesh, control))
    for arch in MOCO_ARCHS:
        for data in DDP_MESHES:
            on(data, 1, f"ddp_moco_{arch}_{data}", lambda mesh: md.run_ddp_moco(mesh, arch, ddp[f"moco_{arch}"]))
    for control in MOCO_CONTROLS:
        on(4, 1, f"ddp_moco_{control}", lambda mesh: md.run_ddp_moco(mesh, "vit", ddp["moco_vit"], control))
    for control in (None, "local_moments"):
        on(2, 1, f"ddp_contrastive_{control}", lambda mesh: md.run_ddp_contrastive(mesh, ddp["contrastive"], control))
    on(2, 1, "ddp_moco_kfold", lambda mesh: md.run_ddp_moco_kfold(mesh, ddp["dirs"]["moco_ranks"], ddp["dirs"]["data"]))
    sharded = ddp["sharded"]
    for variant in fs.VARIANTS:
        on(8, 1, f"fsdp_mae_{variant}", lambda mesh: fs.run_mae(mesh, sharded["mae"], variant=variant))
    on(8, 1, "fsdp_mae_clip_local", lambda mesh: fs.run_mae(mesh, sharded["mae"], variant="clip",
                                                             control_name="clip_local"))
    for control in (None, "lars_local"):
        on(4, 1, f"fsdp_moco_{control}", lambda mesh: fs.run_moco(mesh, ddp["moco_vit"], control))
    for control in (None, "tp_no_f"):
        on(2, 4, f"tp_mae_{control}", lambda mesh: fs.run_mae(mesh, sharded["tp"], fs.TP_CFG, kind="tp",
                                                               control_name=control, attn_impl="flash"))
    on(4, 2, "fsdp_tp_mae", lambda mesh: fs.run_mae(mesh, sharded["tp"], fs.TP_CFG, kind="fsdp", attn_impl="flash"))
    on(2, 4, "ring_mae", lambda mesh: fs.run_mae(mesh, sharded["tp"], fs.TP_CFG, kind="replicated",
                                                 attn_impl="flash_ring"))
    on(2, 1, "fsdp_cli_pretrain", lambda mesh: fs.run_cli_pretrain(mesh, ddp["dirs"]["data"], ddp["dirs"]["fsdp_cli"]))
    on(2, 1, "fsdp_cli_moco", lambda mesh: fs.run_cli_moco(mesh, ddp["dirs"]["data"], ddp["dirs"]["fsdp_cli"]))

    serving = ddp["serving"]
    for kind in sm.SERVE_KINDS:
        for data in sm.SERVE_MESHES:
            on(data, 1, f"serve_{kind}_{data}", lambda mesh: sm.run_serving(mesh, kind, serving))
    on(4, 1, "serve_first_rows", lambda mesh: sm.run_serving(mesh, "features", serving, control=True))
    for data, model in sm.STEP_MESHES:
        for arch in MOCO_ARCHS:
            on(data, model, f"mesh_moco_{arch}_{data}x{model}",
               lambda mesh: sm.run_mesh_moco(mesh, arch, ddp[f"moco_{arch}"]))
        on(data, model, f"mesh_contrastive_{data}x{model}", lambda mesh: sm.run_mesh_contrastive(mesh, ddp["contrastive"]))
    for control in sm.STEP_CONTROLS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mesh = make_mesh(2, 2)
        whole = torch.distributed.new_group(list(range(4)))  # collective: every rank of the world
        if mesh is not None:
            out[f"mesh_moco_{control}"] = (mesh.coords["data"], sm.run_mesh_moco(mesh, "vit", ddp["moco_vit"], control,
                                                                                 whole))
            if control == "world_grads":
                out["mesh_contrastive_world_grads"] = (mesh.coords["data"], sm.run_mesh_contrastive(
                    mesh, ddp["contrastive"], control, whole))
    for case in sm.REPLICA_CASES:
        on(2, 2, f"mesh_moco_{case}", lambda mesh: sm.run_mesh_moco(mesh, "vit", ddp["moco_vit"], case))
    on(2, 2, "mesh_fsdp_moco", lambda mesh: fs.run_moco(mesh, ddp["moco_fsdp_vit"], vit=sm.FSDP_VIT))

    def on_pipe(data, pipe, name, run):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            mesh = make_pipeline_mesh(pipe, data)
        assert len(caught) == (data * pipe < WORLD), [str(w.message) for w in caught]
        if mesh is not None:
            out[name] = (mesh.coords["data"], run(mesh))

    pipes = ddp["pp"]
    for name, (data, pipe, n_mb) in ppt.FEATURE_MESHES.items():
        on_pipe(data, pipe, f"pp_features_{name}", lambda mesh: ppt.run_features(mesh, pipes["trunk"], n_mb))
    on_pipe(1, 4, "pp_features_out_from_first", lambda mesh: ppt.run_features(mesh, pipes["trunk"], 2,
                                                                               "out_from_first"))
    for name, (contrastive, data, pipe) in ppt.MAE_RUNS.items():
        on_pipe(data, pipe, f"pp_mae_{name}", lambda mesh: ppt.run_mae(mesh, pipes[f"mae_{contrastive}"], contrastive))
    for control in ("out_grad_summed", "in_grad_local"):
        on_pipe(2, 2, f"pp_mae_{control}", lambda mesh: ppt.run_mae(mesh, pipes["mae_True"], True, control))
    for data_axis, control in ((None, None), (None, "clip_local"), ("data", None), ("data", "clip_no_pipe")):
        on_pipe(2, 2, f"pp_steps_{data_axis}_{control}", lambda mesh: ppt.run_steps(mesh, pipes["steps"], data_axis,
                                                                                     control))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        meshes = make_pipeline_mesh(2, 2), make_pipeline_mesh(4, 1)
    if meshes[0] is not None:
        out["pp_pretrain"] = (meshes[0].coords["data"], ppt.run_pretrain(*meshes[:1], ddp["dirs"]["data"],
                                                                         ddp["dirs"]["pp_ranks"], meshes[1]))
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


def _pp_references(ddp):
    """The GPipe cases' JAX references: the pipelined features, MAE and
    stage-layout steps."""
    pipes = ddp["pp"]
    pipe_only = ppt.jax_steps(pipes["steps"])
    return {"pp_features": {name: ppt.jax_features(pipes["trunk"], *shape)
                            for name, shape in ppt.FEATURE_MESHES.items()},
            "pp_mae": {name: ppt.jax_mae(pipes[f"mae_{c}"], c, data, pipe)
                       for name, (c, data, pipe) in ppt.MAE_RUNS.items()},
            "pp_steps": {None: pipe_only, "data": fs.with_floor(ppt.jax_steps(pipes["steps"], "data"), pipe_only)}}


def _mesh_references(ddp):
    """The serving mesh's references (JAX's mesh engines and the port's
    one-process ones) and the MoCo and contrastive steps' (JAX's MoCo,
    contrastive and FSDP MoCo steps on the data meshes and on (D, M > 1))."""
    return {"ddp_moco": {arch: md.jax_ddp_moco(arch, ddp[f"moco_{arch}"]) for arch in MOCO_ARCHS},
            "ddp_contrastive": md.jax_ddp_contrastive(ddp["contrastive"]),
            "fsdp_moco": fs.jax_moco_fsdp(ddp["moco_vit"]),
            "serving": {"jax": sm.jax_serving(ddp["serving"]), "one": sm.one_process_serving(ddp["serving"])},
            "mesh_moco": {arch: md.jax_ddp_moco(arch, ddp[f"moco_{arch}"], sm.STEP_MESHES) for arch in MOCO_ARCHS},
            "mesh_contrastive": {shape: md.jax_ddp_contrastive(ddp["contrastive"], *shape)
                                 for shape in sm.STEP_MESHES},
            "mesh_fsdp_moco": fs.jax_moco_fsdp(ddp["moco_fsdp_vit"], data=2, model_axis=2, vit=sm.FSDP_VIT)}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The ranks' results by case ({case: {data coord: [each model rank's
    result]}}) and the JAX references, computed while the ranks run."""
    import threading

    torch.set_num_threads(1)  # the ranks and the other test workers share the cores
    tree, x, want_trunk = _jax_trunk()
    ddp = {"mae": _jax_mae_weights(), "vit": _jax_vit_weights(), "lam": _jax_mixup_lam(),
           "dirs": _ddp_dirs(tmp_path_factory), "contrastive": md.jax_contrastive_weights(),
           **{f"moco_{arch}": md.jax_moco_weights(arch) for arch in MOCO_ARCHS},
           "sharded": {"mae": fs.jax_weights(None, 3), "tp": fs.jax_weights(fs.TP_CFG, 4)},
           "serving": sm.serving_weights(), "moco_fsdp_vit": sm.fsdp_moco_weights(),
           "pp": {"trunk": ppt.trunk_inputs(), "mae_True": ppt.mae_weights(True), "mae_False": ppt.mae_weights(False),
                  "steps": ppt.step_weights()}}
    results = {}
    ranks = threading.Thread(target=lambda: results.update(ranks=run_ranks(
        _group_rank, WORLD, (tree, x, ddp), store_dir=str(tmp_path_factory.mktemp("store")), timeout=600)))
    ranks.start()
    # the GPipe cases' references in a thread of their own beside the others
    # (XLA compiles without the GIL)
    pipelines = threading.Thread(target=lambda: results.update(pp=_pp_references(ddp)))
    pipelines.start()
    # and the MoCo, contrastive and serving mesh's (md.x64 is per thread)
    meshes = threading.Thread(target=lambda: results.update(mesh=_mesh_references(ddp)))
    meshes.start()
    try:
        want = {case: _jax_attention(case) for case in ATTENTION}
        want["trunk"] = want_trunk
        want["mae"] = _mae_step("plain")
        want["ddp_mae"] = _jax_ddp_mae(ddp["mae"])
        want["ddp_mae_generator"] = _ddp_mae_one_process(ddp["mae"])
        want["ddp_supervised"] = {case: _jax_ddp_supervised(case, ddp["vit"]) for case in SUPERVISED}
        want["ddp_pretrain"] = {"dirs": ddp["dirs"], "results": _pretrain_one_process(ddp["dirs"])}
        want["ddp_moco_kfold"] = md.run_moco_kfold(ddp["dirs"]["moco_one"], ddp["dirs"]["data"])
        sharded = ddp["sharded"]
        want["fsdp_mae"] = {variant: fs.jax_mae_run(sharded["mae"], variant=variant) for variant in fs.VARIANTS}
        tp_one = fs.jax_mae_run(sharded["tp"], fs.TP_CFG, kind="replicated", data=1)
        want["tp_mae"] = fs.with_floor(fs.jax_mae_run(sharded["tp"], fs.TP_CFG, kind="tp", data=2, model_axis=4),
                                       tp_one)
        want["fsdp_tp_mae"] = fs.with_floor(
            fs.jax_mae_run(sharded["tp"], fs.TP_CFG, kind="fsdp", data=4, model_axis=2), tp_one)
        want["ring_mae"] = {**tp_one, "floor": want["tp_mae"]["floor"]}
        want["pp_pretrain"] = ppt.pretrain_one_process(ddp["dirs"]["data"], ddp["dirs"]["pp_one"])
    finally:
        pipelines.join()
        meshes.join()
        ranks.join(timeout=900)
    assert not ranks.is_alive() and "ranks" in results, "the group of ranks did not finish"
    assert "pp" in results and "mesh" in results, "the GPipe or the mesh references did not finish"
    want.update(results["pp"])
    want.update(results["mesh"])
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


# ------------------------------------------- data parallelism on (D, 1)

DDP_MESHES = (2, 4)
DDP_B = 8  # the global batch: 4 rows a rank at D = 2, 2 at D = 4
MAE_TINY = "contr_mae_vit_tiny_patch4"  # 16^3 / patch 4: 64 tokens
DDP_LR = 1e-3
SUP_CFG = dict(volume_size=16, patch_size=4, in_chans=1, embed_dim=32, depth=1, num_heads=2, num_classes=2,
               global_pool=True, dtype="float32")
SUP_LABELS = np.array([0, 0, 0, 1, 1, 1, 1, 0])  # at D = 4 the ranks' weight sums are 0.5, 2, 3.5 and 2
CLASS_WEIGHTS = np.array([0.25, 1.75], np.float32)
SUP_LR = 1e-2
SUPERVISED = ("sup_weighted", "sup_mixup", "sup_weighted_local_denominator")
PIPE_FOLDS, PIPE_BATCH = 2, 4
MOCO_ARCHS = ("vit", "resnet")
MOCO_CONTROLS = ("local_keys", "local_moments")


def _ddp_mae_data():
    """The global batch's two views and the masking noise of its 2B rows."""
    rng = np.random.default_rng(21)
    v1, v2 = (rng.standard_normal((DDP_B, 1, 16, 16, 16)).astype(np.float32) for _ in range(2))
    return v1, v2, rng.random((2 * DDP_B, 64)).astype(np.float32)


def _randomised(shapes):
    """Leaves of the shapes of `shapes` (a `jax.eval_shape` of an init):
    LayerNorm and BatchNorm scales and variances near 1, every other leaf
    small, statistics away from their 0/1 start (tests/test_torch_port_mae.py)."""
    import jax

    rng = np.random.default_rng(3)

    def leaf(path, x):
        key = jax.tree_util.keystr(path)
        if key.endswith("['scale']") or key.endswith("['var']"):
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_mae():
    from vit_ae_plus_plus_tpu.models import MODEL_ZOO as JAX_ZOO
    from vit_ae_plus_plus_tpu.models import build_model as jax_build

    return jax_build(JAX_ZOO[MAE_TINY](volume_size=16, dtype="float32"))


def _jax_mae_weights():
    """The tiny contrastive MAE's JAX params and batch_stats (numpy)."""
    import jax
    import jax.numpy as jnp

    v1, v2, _ = _ddp_mae_data()
    variables = _randomised(jax.eval_shape(_jax_mae().init, {"params": jax.random.PRNGKey(1),
                                                             "mask": jax.random.PRNGKey(2)},
                                           jnp.asarray(v1[:2]), jnp.asarray(v2[:2])))
    return variables["params"], variables["batch_stats"]


def _jax_ddp_mae(weights):
    """JAX `make_train_step` on a data mesh of each of `DDP_MESHES` over the
    global batch with its noise injected -> {D: (metrics, the gradients of
    its loss as a state dict, the batch_stats after the step)}."""
    import jax
    import jax.numpy as jnp

    from vit_ae_plus_plus_tpu.parallel import make_mesh as jax_mesh
    from vit_ae_plus_plus_tpu.train import TrainState as JaxTrainState
    from vit_ae_plus_plus_tpu.train import make_adamw as jax_adamw
    from vit_ae_plus_plus_tpu.train import make_train_step as jax_train_step
    from vit_ae_plus_plus_tpu.train.objective import mae_loss_terms as jax_loss_terms

    params, bs = weights
    model = _jax_mae()
    v1, v2, noise = _ddp_mae_data()

    def forward(variables, a, b, _rng):
        out, mutated = model.apply(variables, a, b, mask_ratio=0.75, noise=jnp.asarray(noise),
                                   mutable=["batch_stats"])
        return out, mutated["batch_stats"]

    def loss(p):
        out, _ = forward({"params": p, "batch_stats": bs}, jnp.asarray(v1), jnp.asarray(v2), None)
        return jax_loss_terms(out, jnp.asarray(v1), 4, edge_map_weight=EMW, contr_weight=CONTR_W)[0]

    grads = jax.jit(jax.grad(loss))(params)
    grads = {n: t.numpy() for n, t in params_from_jax(jax.tree.map(np.asarray, grads), 4, 1).items()}
    tx = jax_adamw(DDP_LR)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=bs,
                          opt_state=tx.init(params), tx=tx)
    out = {}
    for data in DDP_MESHES:
        step = jax_train_step(model, 4, contr_weight=CONTR_W, forward_fn=forward, donate=False,
                              mesh=jax_mesh(data=data, devices=jax.devices()[:data]))
        new, metrics = step(state, jnp.asarray(v1), jnp.asarray(v2), jax.random.PRNGKey(0), jnp.float32(EMW))
        new_bs = params_from_jax({}, 4, batch_stats=jax.tree.map(np.asarray, new.batch_stats))
        out[data] = ({k: float(v) for k, v in metrics.items()}, grads, {n: t.numpy() for n, t in new_bs.items()})
    return out


def _port_mae(weights):
    params, bs = weights
    model = build_model(MODEL_ZOO[MAE_TINY](volume_size=16, dtype="float32"))
    model.load_state_dict(params_from_jax(params, 4, 1, bs), strict=True)
    return model


def _mae_step_result(model, state, step, v1, v2):
    state, metrics = step(state, torch.from_numpy(v1), torch.from_numpy(v2), EMW)
    named = dict(model.named_parameters())
    return ({k: float(v) for k, v in metrics.items()}, {n: p.grad.numpy() for n, p in named.items()},
            {n: b.numpy().copy() for n, b in state.batch_stats.items()},
            torch.cat([p.detach().flatten() for p in named.values()]).numpy())


def _run_ddp_mae(mesh, weights, local_moments=False, noise=True):
    """One data-parallel step of the tiny MAE on this rank's rows of the
    global batch: with the global noise's rows injected, or drawn from the
    state's generator (`noise=False`). `local_moments`: the control, each
    rank's BatchNorm on its own rows (the 'data' group's sum of its moments
    left out)."""
    model = _port_mae(weights)
    state = create_train_state(model, make_adamw(DDP_LR))
    v1, v2, global_noise = _ddp_mae_data()
    d, b = mesh.coords["data"], DDP_B // mesh.size("data")
    rows = slice(d * b, (d + 1) * b)
    kw = {}
    if noise:
        mine = torch.from_numpy(np.concatenate([global_noise[rows], global_noise[DDP_B:][rows]]))
        kw["forward_fn"] = lambda m, a, c, _g: m(a, c, noise=mine)
    step = make_train_step(model, 4, contr_weight=CONTR_W, **kw)
    with set_mesh(mesh), md.ddp_control("local_moments" if local_moments else None):
        return _mae_step_result(model, state, step, v1[rows], v2[rows])


def _ddp_mae_one_process(weights):
    """The port's one-process step on the global batch, its noise drawn from
    the state's generator."""
    model = _port_mae(weights)
    state = create_train_state(model, make_adamw(DDP_LR))
    v1, v2, _ = _ddp_mae_data()
    return _mae_step_result(model, state, make_train_step(model, 4, contr_weight=CONTR_W), v1, v2)


def _mae_gate(result, want_metrics, want_grads, want_bs) -> float:
    """The largest of each reading over its f32 limit (loss terms 1e-5
    relative, gradients 1e-4 of their largest magnitude, statistics 1e-6):
    at most 1 inside the gate."""
    metrics, grads, bs, _ = result
    ratios = [abs(metrics[k] - v) / (1e-5 * abs(v) + 1e-7) for k, v in want_metrics.items()]
    ratios += [np.abs(grads[n] - w).max() / (1e-4 * max(np.abs(w).max(), 1e-30)) for n, w in want_grads.items()]
    ratios += [np.abs(bs[n] - w).max() / 1e-6 for n, w in want_bs.items()]
    return float(max(ratios))


def _sup_data():
    x = np.random.default_rng(8).standard_normal((DDP_B, 1, 16, 16, 16)).astype(np.float32)
    return x, SUP_LABELS


def _jax_vit_weights():
    import jax
    import jax.numpy as jnp

    from vit_ae_plus_plus_tpu.configs import ViTConfig as JaxViTConfig
    from vit_ae_plus_plus_tpu.models.vit import VisionTransformer3D as JaxViT

    model = JaxViT(JaxViTConfig(**SUP_CFG, attn_impl="xla"))
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(1)}, jnp.asarray(_sup_data()[0][:2]))
    return _randomised(shapes)["params"]


def _jax_mixup_lam() -> float:
    """The lambda of JAX's timm mixup at the first step of key 3."""
    import jax

    return float(jax.random.beta(jax.random.fold_in(jax.random.PRNGKey(3), 0), 0.1, 0.1).astype(np.float32))


def _jax_ddp_supervised(case, params):
    """JAX `make_supervised_steps(..., mesh=make_mesh(data=4))`, one SGD
    step -> (loss, each parameter's update as a state dict)."""
    import jax
    import jax.numpy as jnp

    from vit_ae_plus_plus_tpu.configs import ViTConfig as JaxViTConfig
    from vit_ae_plus_plus_tpu.models.vit import VisionTransformer3D as JaxViT
    from vit_ae_plus_plus_tpu.parallel import make_mesh as jax_mesh
    from vit_ae_plus_plus_tpu.parallel import replicate, shard_batch
    from vit_ae_plus_plus_tpu.pipelines.finetune import make_supervised_steps as jax_steps
    from vit_ae_plus_plus_tpu.train import TrainState as JaxTrainState
    from vit_ae_plus_plus_tpu.train.optim import make_sgd as jax_sgd

    if case == "sup_weighted_local_denominator":
        return None
    mesh = jax_mesh(data=4, devices=jax.devices()[:4])
    tx = jax_sgd(SUP_LR, momentum=0.9)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                          opt_state=tx.init(params), tx=tx)
    train, _ = jax_steps(JaxViT(JaxViTConfig(**SUP_CFG, attn_impl="xla")), num_classes=2,
                         class_weights=CLASS_WEIGHTS, use_mixup=case == "sup_mixup", mesh=mesh)
    x, labels = _sup_data()
    new, metrics = train(replicate(state, mesh), shard_batch(jnp.asarray(x), mesh),
                         shard_batch(jnp.asarray(labels), mesh), jax.random.PRNGKey(3))
    delta = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), new.params, params)
    return float(metrics["loss"]), {n: t.numpy() for n, t in params_from_jax(delta, 4).items()}


class _Lambda:
    """Draws that give every Beta draw one lambda (JAX's)."""

    def __init__(self, lam):
        self.lam = lam

    def beta(self, a, b):
        return self.lam


def _local_weighted_ce(logits, labels, class_weights, weight_sum):
    """The control: each rank's weighted CE over its own sum of weights, the
    global one (`weight_sum`) ignored; with the step's factor D, the group
    then averages the ranks' own losses, as a plain DDP would."""
    from vit_ae_plus_plus_torch.ops import weighted_ce

    return weighted_ce(logits, labels, class_weights, class_weights[labels].sum() * get_mesh().size("data"))


def _run_ddp_supervised(mesh, case, params, lam):
    """One data-parallel SGD step of the supervised ViT on this rank's rows
    -> (loss, each parameter's update)."""
    from unittest import mock

    from vit_ae_plus_plus_torch.pipelines import finetune as tft

    model = VisionTransformer3D(ViTConfig(**SUP_CFG))
    model.load_state_dict(params_from_jax(params, 4), strict=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, make_sgd(SUP_LR, momentum=0.9))
    train, _ = tft.make_supervised_steps(model, num_classes=2, class_weights=CLASS_WEIGHTS,
                                         use_mixup=case == "sup_mixup")
    x, labels = _sup_data()
    b = DDP_B // mesh.size("data")
    rows = slice(mesh.coords["data"] * b, (mesh.coords["data"] + 1) * b)
    with contextlib.ExitStack() as patches, set_mesh(mesh):
        if case == "sup_mixup":
            patches.enter_context(mock.patch.object(tft.np.random, "default_rng", lambda seed: _Lambda(lam)))
        if case == "sup_weighted_local_denominator":
            patches.enter_context(mock.patch.object(tft, "weighted_ce", _local_weighted_ce))
        _, metrics = train(state, torch.from_numpy(x[rows]), labels[rows], 0)
    return float(metrics["loss"]), {n: (p.detach() - before[n]).numpy() for n, p in model.named_parameters()}


def _ddp_dirs(tmp_path_factory):
    """A BraTS split of 16^3 volumes (whole, train, test) and the work dirs."""
    root = tmp_path_factory.mktemp("ddp_pipelines")
    rng = np.random.default_rng(0)
    for split, n in (("whole", 18), ("train", 9), ("test", 5)):
        np.save(root / f"x_{split}_ssl.npy", rng.standard_normal((n, 16, 16, 16, 1)).astype(np.float32))
        np.save(root / f"y_{split}_ssl.npy", np.arange(n) % 2)
    names = ("ranks", "one", "extract_ranks", "extract_one", "finetune_ranks", "finetune_one", "moco_ranks",
             "moco_one", "fsdp_cli", "pp_ranks", "pp_one")
    return {name: str(root / name) for name in names} | {"data": str(root)}


def _pretrain_cfgs(data_dir):
    """2 epochs of 2 steps of 4 a fold (9 training volumes), with resume
    checkpoints; the features of 9 volumes a split take a padded batch."""
    data_cfg = DataConfig(name="brats", base_path=data_dir, volume_size=16, in_channels=1)
    train_cfg = TrainConfig(batch_size=PIPE_BATCH, patch_size=4, warmup_epochs=1, epochs=2,
                            compute_dtype="float32", contr_weight=0.001, resume=True)
    return data_cfg, train_cfg


def _scipy_policy():
    """The scipy augmentation policy (the native library is left to the
    data tests, which build it)."""
    import contextlib
    from unittest import mock

    from vit_ae_plus_plus_torch.data import transforms as tt
    from vit_ae_plus_plus_torch.pipelines import pretrain_kfold, probe_kfold

    stack = contextlib.ExitStack()
    for module in (pretrain_kfold, probe_kfold):
        stack.enter_context(mock.patch.object(module, "default_ssl_transforms",
                                              lambda: tt.default_ssl_transforms(native="never")))
    return stack


def _finetune_kfold(work, pretrain_dir, **kw):
    """`finetune-kfold` with MixUp3D (the probe pipeline's mixup), one epoch."""
    from vit_ae_plus_plus_torch.pipelines.probe_kfold import probe_kfold

    data_cfg, train_cfg = _pretrain_cfgs(os.path.dirname(work))
    with _scipy_policy():
        return probe_kfold(data_cfg, dataclasses.replace(train_cfg, resume=False), work, pretrain_dir,
                           model_name=MAE_TINY, n_splits=PIPE_FOLDS, fix_backbone=False, use_mixup=True,
                           epochs=1, device="cpu", **kw)


def _run_ddp_pipelines(mesh, dirs):
    """On 2 ranks: `pretrain_kfold`; again with resume after fold 1's
    features were moved aside (the fold restores its last epoch, trains no
    more and extracts again from its min-loss `.pth`); `extract_ssl_features`
    from fold 0's `.pth`; `finetune-kfold` with mixup on the pretrained
    folds. -> (results, resumed results, TensorBoard files after the first
    run, the fine-tune's results)."""
    from vit_ae_plus_plus_torch.pipelines.extract_features import extract_ssl_features
    from vit_ae_plus_plus_torch.pipelines.pretrain_kfold import pretrain_kfold

    data_cfg, train_cfg = _pretrain_cfgs(dirs["data"])
    kw = dict(model_name=MAE_TINY, n_splits=PIPE_FOLDS, n_devices=2, device="cpu")
    feat_dir = os.path.join(dirs["ranks"], "ssl_features_dir")
    with _scipy_policy(), set_mesh(mesh):
        first = pretrain_kfold(data_cfg, train_cfg, dirs["ranks"], **kw)
        tb_files = sorted(os.listdir(os.path.join(dirs["ranks"], "logs")))
        barrier(mesh)
        if mesh.coords["data"] == 0:
            for tag in ("train", "test"):
                name = os.path.join(feat_dir, f"{tag}_contrast_ssl_features_split_1.npy")
                os.replace(name, name + ".first")
        barrier(mesh)
        resumed = pretrain_kfold(data_cfg, train_cfg, dirs["ranks"], **kw)
        extract_ssl_features(data_cfg, _min_loss(dirs["ranks"], 0), dirs["extract_ranks"], model_name=MAE_TINY,
                             batch_size=PIPE_BATCH, patch_size=4, compute_dtype="float32", n_devices=2, device="cpu")
        finetune = _finetune_kfold(dirs["finetune_ranks"], dirs["ranks"], n_devices=2)
    return first, resumed, tb_files, finetune


def _min_loss(work, fold):
    return os.path.join(work, "checkpoints", f"fold_{fold}", "checkpoint-min_loss.pth")


def _pretrain_one_process(dirs):
    """One process at the 2-rank run's rate: without `lr`, 2 ranks take
    blr * batch * 2 / 256 (the JAX package's eff_batch), so one process
    takes twice the base rate."""
    from vit_ae_plus_plus_torch.pipelines.pretrain_kfold import pretrain_kfold

    data_cfg, train_cfg = _pretrain_cfgs(dirs["data"])
    with _scipy_policy():
        return pretrain_kfold(data_cfg, dataclasses.replace(train_cfg, blr=2 * train_cfg.blr), dirs["one"],
                              model_name=MAE_TINY, n_splits=PIPE_FOLDS, device="cpu")


def _ddp_augment_raw():
    return np.random.default_rng(33).standard_normal((DDP_B, 1, 12, 12, 12)).astype(np.float32) * 2 + 3


def _run_ddp_augment(mesh, control):
    """One rank's views of its rows of `_ddp_augment_raw()`, the draws the
    global batch's (`rows`), or with `control` the rank's rows' alone."""
    from vit_ae_plus_plus_torch.ops.augment import device_augment_batch

    d, b = mesh.coords["data"], DDP_B // mesh.size("data")
    raw = torch.from_numpy(_ddp_augment_raw()[d * b:(d + 1) * b])
    views = device_augment_batch(raw, torch.Generator().manual_seed(5), rows=None if control else (d, 2))
    return [v.numpy() for v in views]


def _ddp_results(group, case, data):
    got = group[0][case]
    assert sorted(got) == list(range(data)) and all(len(r) == 1 for r in got.values())
    return [got[d][0] for d in range(data)]


@pytest.mark.parametrize("data", DDP_MESHES)
def test_data_parallel_mae_step_matches_jax(group, data):
    per_rank = _ddp_results(group, f"ddp_mae_{data}", data)
    want_metrics, want_grads, want_bs = group[1]["ddp_mae"][data]
    assert set(want_bs) and set(per_rank[0][1]) == set(want_grads)
    for result in per_rank:
        assert _mae_gate(result, want_metrics, want_grads, want_bs) <= 1.0
    for other in per_rank[1:]:  # one update on every rank, and the same statistics
        np.testing.assert_array_equal(other[3], per_rank[0][3])
        for n, b in per_rank[0][2].items():
            np.testing.assert_array_equal(other[2][n], b)


def test_data_parallel_mae_step_with_local_moments_misses_the_gate(group):
    per_rank = _ddp_results(group, "ddp_mae_local_moments", 4)
    want = group[1]["ddp_mae"][4]
    assert min(_mae_gate(result, *want) for result in per_rank) > 1.0


def test_data_parallel_mae_step_draws_the_global_batch_noise(group):
    """The masking noise from the state's generator: each rank's rows of the
    global batch's noise, so the step is the one-process step's."""
    per_rank = _ddp_results(group, "ddp_mae_generator", 2)
    metrics, grads, bs, _ = group[1]["ddp_mae_generator"]
    for result in per_rank:
        assert _mae_gate(result, metrics, grads, bs) <= 1.0
    np.testing.assert_array_equal(per_rank[0][3], per_rank[1][3])


@pytest.mark.parametrize("case", ["sup_weighted", "sup_mixup"])
def test_data_parallel_supervised_step_matches_jax(group, case):
    """Unequal class weights on the ranks; with mixup, timm's flip pairs
    rows of different ranks."""
    per_rank = _ddp_results(group, f"ddp_{case}", 4)
    want_loss, want_delta = group[1]["ddp_supervised"][case]
    for loss, delta in per_rank:
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (loss, want_loss)
        for n, w in want_delta.items():
            assert np.abs(delta[n] - w).max() <= 1e-4 * np.abs(w).max(), n
    for _, delta in per_rank[1:]:
        for n, w in per_rank[0][1].items():
            np.testing.assert_array_equal(delta[n], w)


def test_data_parallel_supervised_step_with_local_weight_sums_misses(group):
    per_rank = _ddp_results(group, "ddp_sup_weighted_local_denominator", 4)
    want_loss, want_delta = group[1]["ddp_supervised"]["sup_weighted"]
    for loss, delta in per_rank:
        assert abs(loss - want_loss) > 1e-5 * abs(want_loss)
        assert max(np.abs(delta[n] - w).max() / np.abs(w).max() for n, w in want_delta.items()) > 1e-4


def _features(work, fold, tag, what="features"):
    return np.load(os.path.join(work, "ssl_features_dir", f"{tag}_contrast_ssl_{what}_split_{fold}.npy"))


def test_data_parallel_pretrain_kfold_and_its_resume_match_one_process(group):
    (first, resumed, tb_files, _), _ = _ddp_results(group, "ddp_pipelines", 2)
    dirs = group[1]["ddp_pretrain"]["dirs"]
    want = group[1]["ddp_pretrain"]["results"]
    ranks, one = dirs["ranks"], dirs["one"]
    assert set(first) == set(want) == {0, 1} and resumed[0] == {"skipped": True}
    for fold in range(PIPE_FOLDS):
        assert abs(first[fold]["min_loss"] - want[fold]["min_loss"]) <= 1e-5 * abs(want[fold]["min_loss"])
        got_sd, want_sd = load_reference_state_dict(_min_loss(ranks, fold)), load_reference_state_dict(_min_loss(one, fold))
        assert set(got_sd) == set(want_sd)
        for n, w in want_sd.items():
            assert float((got_sd[n] - w).abs().max()) <= 1e-5 * max(float(w.abs().max()), 1.0), n
        for tag in ("train", "test"):
            got, w = _features(ranks, fold, tag), _features(one, fold, tag)
            assert got.shape == w.shape == (9, 24) and got.dtype == np.float32
            assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max(), (fold, tag)
            np.testing.assert_array_equal(_features(ranks, fold, tag, "labels"), _features(one, fold, tag, "labels"))
    for tag in ("train", "test"):  # the resumed fold's features again, from the same .pth
        first_copy = os.path.join(ranks, "ssl_features_dir", f"{tag}_contrast_ssl_features_split_1.npy.first")
        np.testing.assert_array_equal(_features(ranks, 1, tag), np.load(first_copy))
    # one writer: the one-process run's log rows, one TensorBoard file
    with open(os.path.join(ranks, "checkpoints", "log.txt")) as f, open(os.path.join(one, "checkpoints", "log.txt")) as g:
        got_rows, want_rows = [json.loads(x) for x in f], [json.loads(x) for x in g]
    assert len(got_rows) == len(want_rows) == PIPE_FOLDS * 2
    for r, w in zip(got_rows, want_rows):
        assert (r["fold"], r["epoch"]) == (w["fold"], w["epoch"])
        assert abs(r["train_loss"] - w["train_loss"]) <= 1e-5 * abs(w["train_loss"])
    assert len(tb_files) == 1 and os.listdir(os.path.join(ranks, "k_fold", "indices_file"))


def test_data_parallel_pretrain_kfold_logs_the_jax_learning_rate(group, tmp_path):
    """Without `lr`, the JAX package's `pretrain_one_fold` under a (2, 1)
    mesh counts the global batch twice in its rate (eff_batch = batch *
    accum_iter * 2, pretrain_kfold.py:122 there); the 2-rank port logs the
    same `train_lr`."""
    import jax

    from vit_ae_plus_plus_tpu.configs import DataConfig as JDataConfig
    from vit_ae_plus_plus_tpu.configs import TrainConfig as JTrainConfig
    from vit_ae_plus_plus_tpu.data import get_dataset
    from vit_ae_plus_plus_tpu.parallel import make_mesh as jax_make_mesh
    from vit_ae_plus_plus_tpu.pipelines.pretrain_kfold import pretrain_one_fold

    _ddp_results(group, "ddp_pipelines", 2)
    dirs = group[1]["ddp_pretrain"]["dirs"]
    data_cfg, train_cfg = _pretrain_cfgs(dirs["data"])
    jdata = JDataConfig(**{k: getattr(data_cfg, k) for k in ("name", "base_path", "volume_size", "in_channels")})
    jtrain = JTrainConfig(**{k: getattr(train_cfg, k) for k in ("batch_size", "patch_size", "warmup_epochs", "epochs",
                                                                 "compute_dtype", "contr_weight", "lr")})
    assert jtrain.lr is None
    ids = np.load(os.path.join(dirs["ranks"], "k_fold", "indices_file", "train_0.npy"))
    mesh = jax_make_mesh(data=2, devices=jax.devices()[:2])
    pretrain_one_fold(0, ids, get_dataset("brats", "whole", jdata, transforms=None), jtrain, MAE_TINY, jdata,
                      str(tmp_path), mesh=mesh)
    with open(os.path.join(tmp_path, "checkpoints", "log.txt")) as f:
        want = [json.loads(x) for x in f]
    with open(os.path.join(dirs["ranks"], "checkpoints", "log.txt")) as f:
        got = [json.loads(x) for x in f if json.loads(x)["fold"] == 0]
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
    for r, w in zip(got, want):
        assert abs(r["train_lr"] - w["train_lr"]) <= 1e-6 * w["train_lr"], (r["train_lr"], w["train_lr"])
    assert want[-1]["train_lr"] > 0


@pytest.mark.parametrize("control", [False, True])
def test_data_parallel_augmentation_draws_for_the_global_batch(group, control):
    from vit_ae_plus_plus_torch.ops.augment import device_augment_batch

    per_rank = _ddp_results(group, f"ddp_augment_{control}", 2)
    whole = device_augment_batch(torch.from_numpy(_ddp_augment_raw()), torch.Generator().manual_seed(5))
    b = DDP_B // 2
    same = all(np.array_equal(views[i], whole[i][d * b:(d + 1) * b].numpy())
               for d, views in enumerate(per_rank) for i in range(2))
    assert same != control


def test_data_parallel_extract_features_matches_one_process(group):
    from vit_ae_plus_plus_torch.pipelines.extract_features import extract_ssl_features

    _ddp_results(group, "ddp_pipelines", 2)
    dirs = group[1]["ddp_pretrain"]["dirs"]
    data_cfg, _ = _pretrain_cfgs(dirs["data"])
    extract_ssl_features(data_cfg, _min_loss(dirs["ranks"], 0), dirs["extract_one"], model_name=MAE_TINY,
                         batch_size=PIPE_BATCH, patch_size=4, compute_dtype="float32", device="cpu")
    for split, n in (("train", 9), ("test", 5)):
        got = np.load(os.path.join(dirs["extract_ranks"], f"{split}_features.npy"))
        want = np.load(os.path.join(dirs["extract_one"], f"{split}_features.npy"))
        assert got.shape == want.shape == (n, 24)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), split
        np.testing.assert_array_equal(np.load(os.path.join(dirs["extract_ranks"], f"{split}_gt_labels.npy")),
                                      np.load(os.path.join(dirs["extract_one"], f"{split}_gt_labels.npy")))


def test_data_parallel_finetune_kfold_matches_one_process(group):
    """`finetune-kfold` with MixUp3D's permutation over the global batch, on
    2 ranks: every rank returns the one-process run's test statistics, and
    the best models are written once, as one process writes them."""
    (*_, got), (*_, other) = _ddp_results(group, "ddp_pipelines", 2)
    dirs = group[1]["ddp_pretrain"]["dirs"]
    want = _finetune_kfold(dirs["finetune_one"], dirs["ranks"])
    assert got.keys() == other.keys() == want.keys() == {0, 1}
    for fold, by_name in want.items():
        assert got[fold].keys() == other[fold].keys() == by_name.keys() and by_name
        for name, stats in by_name.items():
            assert got[fold][name] == other[fold][name]
            for k, v in stats.items():
                assert abs(got[fold][name][k] - v) <= 1e-5 * max(abs(v), 1.0), (fold, name, k)
    best = sorted(os.listdir(os.path.join(dirs["finetune_one"], "checkpoints")))
    assert sorted(os.listdir(os.path.join(dirs["finetune_ranks"], "checkpoints"))) == best
    for name in best:
        got_sd = load_reference_state_dict(os.path.join(dirs["finetune_ranks"], "checkpoints", name))
        want_sd = load_reference_state_dict(os.path.join(dirs["finetune_one"], "checkpoints", name))
        for n, w in want_sd.items():
            assert float((got_sd[n] - w).abs().max()) <= 1e-5 * max(float(w.abs().max()), 1.0), (name, n)


@pytest.mark.parametrize("arch", MOCO_ARCHS)
@pytest.mark.parametrize("data", DDP_MESHES)
def test_data_parallel_moco_step_matches_jax(group, arch, data):
    """Each rank's loss, gradients and both encoders' statistics against
    JAX's data-mesh step (`md.ddp_gate`); the parameters after the LARS
    step and the statistics bitwise equal on every rank."""
    per_rank = _ddp_results(group, f"ddp_moco_{arch}_{data}", data)
    want = group[1]["ddp_moco"][arch][data, 1]
    for result in per_rank:
        assert md.ddp_gate(result, want, md.MOCO_TOL[arch]) <= 1.0
    for other in per_rank[1:]:
        np.testing.assert_array_equal(other[3], per_rank[0][3])
        for n, b in per_rank[0][2].items():
            np.testing.assert_array_equal(other[2][n], b)


@pytest.mark.parametrize("control", MOCO_CONTROLS)
def test_data_parallel_moco_step_controls_miss(group, control):
    """Each rank's queries against its own keys only miss the loss's limit;
    BatchNorm on each rank's rows alone misses on the predictor's running
    statistics."""
    per_rank = _ddp_results(group, f"ddp_moco_{control}", 4)
    want_loss, want_grads, want_stats = group[1]["ddp_moco"]["vit"][4, 1]
    for loss, grads, stats, _ in per_rank:
        if control == "local_keys":
            assert md.ddp_gate((loss, want_grads, want_stats), group[1]["ddp_moco"]["vit"][4, 1]) > 1.0
        else:
            predictor = {n: w for n, w in want_stats.items() if n.startswith("predictor.")}
            assert predictor and md.ddp_gate((want_loss, want_grads, stats), (want_loss, want_grads, predictor)) > 1.0


def test_data_parallel_contrastive_step_matches_jax(group):
    per_rank = _ddp_results(group, "ddp_contrastive_None", 2)
    want = group[1]["ddp_contrastive"]
    for result in per_rank:
        assert md.ddp_gate(result, want) <= 1.0
    np.testing.assert_array_equal(per_rank[1][3], per_rank[0][3])


def test_data_parallel_contrastive_step_with_local_moments_misses(group):
    per_rank = _ddp_results(group, "ddp_contrastive_local_moments", 2)
    for result in per_rank:
        assert md.ddp_gate(result, group[1]["ddp_contrastive"]) > 1.0


def test_data_parallel_moco_kfold_and_its_resume_match_one_process(group):
    """`moco_kfold` on 2 ranks against one process's run (f32: the losses
    within 1e-5 relative, the min-loss weights within 1e-5 of their
    magnitude, the features within 1e-4 of their largest after 4 LARS
    steps); the resumed run restores every fold on both ranks, trains no
    more and writes the same features bitwise."""
    per_rank = _ddp_results(group, "ddp_moco_kfold", 2)
    dirs = group[1]["ddp_pretrain"]["dirs"]
    want = group[1]["ddp_moco_kfold"]
    ranks, one = dirs["moco_ranks"], dirs["moco_one"]
    for first, resumed in per_rank:
        assert first == resumed and sorted(first) == sorted(want) == [0, 1]
        for fold in (0, 1):
            assert abs(first[fold]["min_loss"] - want[fold]["min_loss"]) <= 1e-5 * abs(want[fold]["min_loss"])
    with open(os.path.join(ranks, "log.txt")) as f, open(os.path.join(one, "log.txt")) as g:
        got_rows, want_rows = [json.loads(x) for x in f], [json.loads(x) for x in g]
    assert [(r["fold"], r["epoch"]) for r in got_rows] == [(r["fold"], r["epoch"]) for r in want_rows] == [
        (k, e) for k in (0, 1) for e in (0, 1)]
    for r, w in zip(got_rows, want_rows):
        assert abs(r["train_loss"] - w["train_loss"]) <= 1e-5 * abs(w["train_loss"])
    for fold in (0, 1):
        got_sd, want_sd = (torch.load(os.path.join(work, "checkpoints", f"fold_{fold}", "checkpoint-min_loss.pth"),
                                      map_location="cpu", weights_only=True) for work in (ranks, one))
        assert set(got_sd) == set(want_sd)
        for n, w in want_sd.items():
            assert float((got_sd[n] - w).abs().max()) <= 1e-5 * max(float(w.abs().max()), 1.0), n
        assert os.path.exists(os.path.join(ranks, "checkpoints", f"fold_{fold}", "resume-state.pth"))
    feat_dir, want_dir = os.path.join(ranks, "ssl_features_dir"), os.path.join(one, "ssl_features_dir")
    names = sorted(os.listdir(want_dir))
    assert len(names) == 8 and sorted(n for n in os.listdir(feat_dir) if not n.endswith(".first")) == names
    for name in names:
        got, w = np.load(os.path.join(feat_dir, name)), np.load(os.path.join(want_dir, name))
        np.testing.assert_array_equal(got, np.load(os.path.join(feat_dir, name + ".first")))
        assert got.shape == w.shape and got.dtype == w.dtype
        if "labels" in name:
            np.testing.assert_array_equal(got, w)
        else:
            assert np.abs(got - w).max() <= 1e-4 * np.abs(w).max(), name


# ------------------------------------------- the sharded training state

def _mesh_results(group, case, data, model):
    """Every rank's result of `case`, and each rank's (d, m)."""
    got = group[0][case]
    assert sorted(got) == list(range(data)) and all(len(r) == model for r in got.values())
    results = [r for d in range(data) for r in got[d]]
    assert sorted(r["coords"] for r in results) == [(d, m) for d in range(data) for m in range(model)]
    return results


def _assert_eval_matches_one_process(results):
    """`make_eval_step` on the sharded model against one process's on a
    whole copy of it, each rank's rows."""
    for r in results:
        for k, (sharded, one) in r["eval"].items():
            assert abs(sharded - one) <= 1e-6 * abs(one) + 1e-9, (k, sharded, one)


def _assert_blocks_agree(results):
    """Each leaf's local tensor bitwise equal on the ranks that hold the same
    block: every rank for a replicated leaf, the ranks of the axis a block
    is not cut on for a sharded one."""
    axis_index = {"data": 0, "model": 1}
    for name in results[0]["local"]:
        held = {}
        for r in results:
            key = tuple(r["coords"][axis_index[a]] for a in sorted(r["placements"].get(name, {})))
            held.setdefault(key, []).append(r["local"][name])
        for blocks in held.values():
            for other in blocks[1:]:
                np.testing.assert_array_equal(other, blocks[0], err_msg=name)


def _assert_fsdp_transport(result, extra=()):
    """FSDP's collectives move the blocks of 'data'-sharded leaves (gathers),
    those leaves whole over 'data' (gloo's reduce-scatter), the flat
    replicated gradients and vectors of statistics (1-D): never an
    activation. `extra`: the shapes a step gathers by design (MoCo's
    keys)."""
    data = result["mesh"][0]
    blocks, wholes = set(), set()
    for name, dims in result["placements"].items():
        if "data" in dims:
            shape = result["local"][name].shape
            blocks.add(shape)
            wholes.add(tuple(s * (data if i == dims["data"] else 1) for i, s in enumerate(shape)))
    gathers = {s for axis, s in result["log"]["all_gather"] if axis == "data"}
    reduces = [s for axis, s in result["log"]["all_reduce"] if axis == "data"]
    assert gathers and gathers <= blocks | set(extra), gathers
    assert all(len(s) == 1 or s in wholes for s in reduces), reduces


@pytest.mark.parametrize("variant", fs.VARIANTS)
def test_fsdp_mae_step_matches_jax(group, variant):
    results = _mesh_results(group, f"fsdp_mae_{variant}", 8, 1)
    want = group[1]["fsdp_mae"][variant]
    if variant == "clip":
        assert all(m["grad_norm"] > fs.CLIP for m in want["metrics"])
    for r in results:
        assert fs.mae_gate(r, want) <= 1.0
    _assert_blocks_agree(results)
    _assert_eval_matches_one_process(results)
    _assert_fsdp_transport(results[0])
    qkv = "blocks.0.attn.qkv.weight"
    assert results[0]["local"][qkv].shape == (72 // 8, 24) and results[0]["placements"][qkv] == {"data": 0}


def test_fsdp_mae_step_with_a_shard_local_clip_norm_misses(group):
    results = _mesh_results(group, "fsdp_mae_clip_local", 8, 1)
    assert min(fs.mae_gate(r, group[1]["fsdp_mae"]["clip"]) for r in results) > 1.0


@pytest.mark.parametrize("control", [None, "lars_local"])
def test_fsdp_moco_step_matches_jax(group, control):
    results = _mesh_results(group, f"fsdp_moco_{control}", 4, 1)
    want = group[1]["fsdp_moco"]
    gates = [fs.moco_gate(r, want) for r in results]
    if control is None:
        assert max(gates) <= 1.0
        _assert_blocks_agree(results)
        _assert_fsdp_transport(results[0], extra={(md.MOCO_B // 4, 2 * md.DIM)})  # the keys
        assert any("head" in n for n in results[0]["placements"])
    else:
        assert min(gates) > 1.0


@pytest.mark.parametrize("control", [None, "tp_no_f"])
def test_tp_step_on_2x4_matches_jax(group, control):
    results = _mesh_results(group, f"tp_mae_{control}", 2, 4)
    want = group[1]["tp_mae"]
    if control is not None:
        assert min(fs.mae_gate(r, want) for r in results) > 1.0
        return
    for r in results:
        assert fs.mae_gate(r, want) <= 1.0
        # no rank holds the whole (C, 3C) qkv, and TP gathers nothing
        c = fs.TP_CFG["embed_dim"]
        assert r["local"]["blocks.0.attn.qkv.weight"].shape == (3 * c // 4, c)
        assert r["local"]["decoder_blocks.0.attn.qkv.weight"].shape == (3 * c // 4, c)
        assert not r["log"]["all_gather"] and (3 * c, c) not in {s for _, s in r["log"]["all_reduce"]}
    _assert_blocks_agree(results)
    _assert_eval_matches_one_process(results)


def test_fsdp_composed_with_tp_on_4x2_matches_jax(group):
    results = _mesh_results(group, "fsdp_tp_mae", 4, 2)
    want = group[1]["fsdp_tp_mae"]
    for r in results:
        assert fs.mae_gate(r, want) <= 1.0
        assert r["placements"]["blocks.0.attn.qkv.weight"] == {"model": 0, "data": 1}
        c = fs.TP_CFG["embed_dim"]
        assert r["local"]["blocks.0.attn.qkv.weight"].shape == (3 * c // 2, c // 4)
    _assert_blocks_agree(results)
    _assert_eval_matches_one_process(results)
    _assert_fsdp_transport(results[0])


def test_flash_ring_step_on_2x4_matches_jax(group):
    results = _mesh_results(group, "ring_mae", 2, 4)
    for r in results:
        assert fs.mae_gate(r, group[1]["ring_mae"]) <= 1.0
    _assert_blocks_agree(results)


def test_pretrain_kfold_fsdp_cli_resumes_across_layouts(group):
    """A: --fsdp straight; B: a data-parallel epoch resumed under --fsdp; C:
    an --fsdp epoch resumed data parallel. The same training, so the same
    losses and weights within f32 summation order; each .pth loads into one
    process's model."""
    out, _ = _ddp_results(group, "fsdp_cli_pretrain", 2)
    root = group[1]["ddp_pretrain"]["dirs"]["fsdp_cli"]
    model = build_model(MODEL_ZOO[MAE_TINY](volume_size=16, dtype="float32"))
    for fold in range(PIPE_FOLDS):
        want_sd = load_reference_state_dict(_min_loss(os.path.join(root, "A"), fold))
        model.load_state_dict(want_sd, strict=True)
        for run in ("B", "C"):
            assert abs(out[run][fold]["min_loss"] - out["A"][fold]["min_loss"]) <= 1e-5 * out["A"][fold]["min_loss"]
            got_sd = load_reference_state_dict(_min_loss(os.path.join(root, run), fold))
            for n, w in want_sd.items():
                assert float((got_sd[n] - w).abs().max()) <= 1e-5 * max(float(w.abs().max()), 1.0), (run, n)
    with open(os.path.join(root, "A", "checkpoints", "log.txt")) as f:
        assert len(f.readlines()) == PIPE_FOLDS * 2


def test_moco_kfold_fsdp_cli_resumes_across_layouts(group):
    """A: --fsdp, then resumed data parallel (A'); D: data parallel, then
    resumed under --fsdp (D'). A resumed fold restores its state whole and
    extracts again from its .pth: the same features bitwise; A and D train
    the same steps within f32 summation order."""
    from vit_ae_plus_plus_torch.configs import DataConfig
    from vit_ae_plus_plus_torch.pipelines import moco_kfold as tmk

    out, _ = _ddp_results(group, "fsdp_cli_moco", 2)
    root = group[1]["ddp_pretrain"]["dirs"]["fsdp_cli"]
    model = tmk.build_moco_model(DataConfig(volume_size=16), "float32", "vit", **md.MOCO)
    for run in ("A", "D"):
        work = os.path.join(root, f"moco_{run}")
        assert out[run + "'"] == out[run]
        for fold in range(PIPE_FOLDS):
            for tag in ("train", "test"):
                name = f"{tag}_contrast_ssl_features_split_{fold}.npy"
                np.testing.assert_array_equal(np.load(os.path.join(work, "ssl_features_dir", name)),
                                              np.load(os.path.join(work, "ssl_features_dir.first", name)))
            model.load_state_dict(torch.load(_min_loss(work, fold), weights_only=True), strict=True)
    for fold in range(PIPE_FOLDS):
        assert abs(out["D"][fold]["min_loss"] - out["A"][fold]["min_loss"]) <= 1e-5 * out["A"][fold]["min_loss"]
        a = torch.load(_min_loss(os.path.join(root, "moco_A"), fold), weights_only=True)
        d = torch.load(_min_loss(os.path.join(root, "moco_D"), fold), weights_only=True)
        for n, w in a.items():
            assert float((d[n] - w).abs().max()) <= 1e-5 * max(float(w.abs().max()), 1.0), n


# ------------------------------------------------------------ the GPipe pipeline

def _pp_results(group, case, data, pipe):
    """Every rank's result of a pipeline case, in (d, p) order."""
    got = group[0][case]
    assert sorted(got) == list(range(data)) and all(len(r) == pipe for r in got.values())
    return [r for d in range(data) for r in got[d]]


def _pp_close(got, want, what):
    """Within 1e-5 of the largest magnitude of `want` (at least 1e-5)."""
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * max(float(np.abs(want).max()), 1.0), (what, err)


def _pp_grads(results, want):
    """Every leaf's gradient on every rank that computes it against JAX's;
    each leaf computed somewhere; a leaf outside the stacks, which every
    stage computes, bitwise equal on every rank."""
    seen = {}
    for r in results:
        for n, g in r["grads"].items():
            _pp_close(g, want[n], n)
            seen.setdefault(n, []).append(g)
    assert set(seen) == set(want)
    for n, copies in seen.items():
        if not n.startswith(("blocks.", "decoder_blocks.")):
            assert len(copies) == len(results), n
            for other in copies[1:]:
                np.testing.assert_array_equal(other, copies[0], err_msg=n)


def _pp_miss(results, want, key="grads"):
    """The largest error over its 1e-5 limit across the ranks' readings."""
    worst = 0.0
    for r in results:
        items = r[key].items() if key == "grads" else [("features", r["features"])]
        for n, g in items:
            w = want[key][n] if key == "grads" else want["features"][slice(*r["rows"])]
            worst = max(worst, float(np.abs(g - w).max()) / (1e-5 * max(float(np.abs(w).max()), 1.0)))
    return worst


@pytest.mark.parametrize("mesh_name", list(ppt.FEATURE_MESHES))
def test_pipelined_features_and_grads_match_jax(group, mesh_name):
    data, pipe, _ = ppt.FEATURE_MESHES[mesh_name]
    results = _pp_results(group, f"pp_features_{mesh_name}", data, pipe)
    feats, grads = group[1]["pp_features"][mesh_name]
    for r in results:
        _pp_close(r["features"], feats[slice(*r["rows"])], "features")
    _pp_grads(results, grads)
    held = {n.split(".")[1] for r in results[:pipe] for n in r["grads"] if n.startswith("blocks.")}
    assert held == {str(i) for i in range(ppt.TRUNK_CFG["depth"])}


def test_pipelined_features_from_the_first_stage_miss(group):
    feats, grads = group[1]["pp_features"]["1x4"]
    results = _pp_results(group, "pp_features_out_from_first", 1, 4)
    assert _pp_miss(results, {"features": feats}, "features") > 1


_TOKEN_ROWS = ("p1", "p2", "z1", "z2")


@pytest.mark.parametrize("run", list(ppt.MAE_RUNS))
def test_pipelined_mae_forward_grads_and_statistics_match_jax(group, run):
    contrastive, data, pipe = ppt.MAE_RUNS[run]
    results = _pp_results(group, f"pp_mae_{run}", data, pipe)
    want = group[1]["pp_mae"][run]
    b = ppt.MAE_B // data
    for r in results:
        assert abs(r["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        lo, hi = r["rows"]
        for k, w in want["outputs"].items():
            got = r["outputs"][k]
            rows = slice(lo * got.shape[0] // b, hi * got.shape[0] // b) if k in _TOKEN_ROWS else slice(lo, hi)
            _pp_close(got.astype(np.float64), np.asarray(w, np.float64)[rows], k)
        for n, w in want["stats"].items():
            assert np.abs(r["stats"][n] - w).max() <= 1e-6, n
    assert set(want["outputs"]) == ({"pred", "mask", "ids_restore", "latent"} | (set(_TOKEN_ROWS) if contrastive
                                                                                else set()))
    _pp_grads(results, want["grads"])


@pytest.mark.parametrize("control", ["out_grad_summed", "in_grad_local"])
def test_pipelined_mae_gradient_controls_miss(group, control):
    results = _pp_results(group, f"pp_mae_{control}", 2, 2)
    assert _pp_miss(results, group[1]["pp_mae"]["contrastive_2x2"]) > 1


@pytest.mark.parametrize("data_axis", [None, "data"])
def test_stage_layout_steps_match_jax(group, data_axis):
    """Two clipped AdamW steps on (2, 2), pipe alone and with FSDP
    composed: metrics, parameters and moments against JAX's stacked-state
    step (`fs.mae_gate`), every stage's leaves outside the stacks bitwise
    equal across all ranks, each block leaf across the ranks that hold it
    whole, and its control missing."""
    want = group[1]["pp_steps"][data_axis]
    results = _pp_results(group, f"pp_steps_{data_axis}_None", 2, 2)
    for r in results:
        mu, nu = {}, {}
        for other in results:
            mu.update(other["mu"])
            nu.update(other["nu"])
        assert fs.mae_gate({**r, "mu": mu, "nu": nu}, want) <= 1
    for name in results[0]["local"]:
        if not name.startswith(("blocks.", "decoder_blocks.")):
            for r in results[1:]:
                np.testing.assert_array_equal(r["local"][name], results[0]["local"][name], err_msg=name)
    by_stage = [[r for r in results if any(n.startswith("blocks.0.") for n in r["local"]) == (p == 0)]
                for p in range(2)]
    for stage in by_stage:
        assert len(stage) == 2
        for name, dims in stage[0]["placements"].items():
            if "data" not in dims:
                np.testing.assert_array_equal(stage[1]["local"][name], stage[0]["local"][name], err_msg=name)
    sharded = [n for n, dims in results[0]["placements"].items() if "data" in dims]
    assert bool(sharded) == (data_axis is not None)
    control = "clip_local" if data_axis is None else "clip_no_pipe"
    for r in _pp_results(group, f"pp_steps_{data_axis}_{control}", 2, 2):
        assert fs.mae_gate({**r, "mu": {**want["mu"], **r["mu"]}, "nu": {**want["nu"], **r["nu"]}}, want) > 1


def test_export_torch_merges_the_pipelined_runs_stage_files(group, tmp_path):
    """`export-torch` of the per-stage resume files that the pipelined
    `pretrain_kfold` above wrote on (2, 2): every leaf from the stage file
    that holds it, and the whole equal, key for key and bitwise, to the JAX
    package's `export_mae_torch_state_dict` of the same weights and
    statistics."""
    from vit_ae_plus_plus_tpu.models import MODEL_ZOO as JAX_ZOO
    from vit_ae_plus_plus_tpu.train.checkpoint import (
        export_mae_torch_state_dict,
        import_torch_batch_stats,
        import_torch_state_dict,
    )
    from vit_ae_plus_plus_torch import cli

    resume = os.path.join(group[1]["ddp_pretrain"]["dirs"]["pp_ranks"], "checkpoints", "fold_0", "resume")
    out = tmp_path / "mae.pth"
    assert cli.main(["export-torch", "--checkpoint", resume, "--out", str(out), "--model", ppt.PP_MODEL,
                     "--volume-size", str(ppt.VOL)]) == 0
    got = torch.load(out, map_location="cpu", weights_only=True)
    stages = [torch.load(os.path.join(resume, f"checkpoint-stage{p}.pth"), map_location="cpu",
                         weights_only=True)["model"] for p in range(2)]
    blocks = [{k for k in sd if k.startswith(("blocks.", "decoder_blocks."))} for sd in stages]
    assert blocks[0] and blocks[1] and not blocks[0] & blocks[1]
    for p, sd in enumerate(stages):
        for k in (sd if p == 0 else blocks[p]):
            assert torch.equal(got[k], sd[k]), (p, k)
    arrays = {k: v.numpy() for k, v in got.items()}
    want = export_mae_torch_state_dict(import_torch_state_dict(arrays, ppt.PATCH, 1, mae=True),
                                       JAX_ZOO[ppt.PP_MODEL](volume_size=ppt.VOL), import_torch_batch_stats(arrays))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].numpy().dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def test_pipelined_pretrain_kfold_matches_one_process_and_refuses_another_layout(group):
    """`pretrain_kfold` with pipe_devices=2 on (2, 2) against one process at
    the same rate, weights, noise and rows: the min losses, each per-layer
    `.pth` (loaded into the one-process model), the log rows and the
    features; a `.pth` with the stages' blocks swapped misses; the resume
    files per stage and `layout.json`; a resume with pipe_devices=4
    refused."""
    (results, refusal), *others = _pp_results(group, "pp_pretrain", 2, 2)
    dirs = group[1]["ddp_pretrain"]["dirs"]
    want = group[1]["pp_pretrain"]
    work, one = dirs["pp_ranks"], dirs["pp_one"]
    assert all(o[0] == results for o in others)
    assert refusal is not None and "were written with --pipe-devices 2; this run uses --pipe-devices 4" in refusal
    model = build_model(MODEL_ZOO[ppt.PP_MODEL](volume_size=16, dtype="float32"))
    for fold in range(ppt.PP_FOLDS):
        assert abs(results[fold]["min_loss"] - want[fold]["min_loss"]) <= 1e-5 * abs(want[fold]["min_loss"])
        got_sd, want_sd = load_reference_state_dict(_min_loss(work, fold)), load_reference_state_dict(_min_loss(one, fold))
        assert list(got_sd) == list(want_sd)
        model.load_state_dict(got_sd, strict=True)
        for n, w in want_sd.items():
            assert float((got_sd[n] - w).abs().max()) <= 1e-5 * max(float(w.abs().max()), 1.0), n
        swapped = {n.replace("blocks.0.", "blocks.X.").replace("blocks.1.", "blocks.0.").replace("blocks.X.",
                                                                                               "blocks.1."): v
                   for n, v in got_sd.items()}
        assert max(float((swapped[n] - w).abs().max()) for n, w in want_sd.items()) > 1e-4
        for tag in ("train", "test"):
            got = _features(work, fold, tag) if fold == 0 else np.load(os.path.join(
                work, "ssl_features_dir", f"{tag}_contrast_ssl_features_split_1.npy.first"))
            w = _features(one, fold, tag)
            assert got.shape == w.shape and np.abs(got - w).max() <= 1e-5 * np.abs(w).max(), (fold, tag)
        resume = os.path.join(work, "checkpoints", f"fold_{fold}", "resume")
        assert sorted(os.listdir(resume)) == ["checkpoint-stage0.pth", "checkpoint-stage1.pth", "layout.json"]
        with open(os.path.join(resume, "layout.json")) as f:
            assert json.load(f) == {"pipe": 2}
    with open(os.path.join(work, "checkpoints", "log.txt")) as f, open(os.path.join(one, "checkpoints", "log.txt")) as g:
        got_rows, want_rows = [json.loads(x) for x in f], [json.loads(x) for x in g]
    assert len(got_rows) == len(want_rows) == ppt.PP_FOLDS * 2
    for r, w in zip(got_rows, want_rows):
        assert abs(r["train_loss"] - w["train_loss"]) <= 1e-5 * abs(w["train_loss"])


# ------------------------------------------ the serving mesh and (D, M > 1) steps

@pytest.mark.parametrize("kind", sm.SERVE_KINDS)
@pytest.mark.parametrize("data", sm.SERVE_MESHES)
def test_serving_mesh_matches_jax_and_one_process(group, kind, data):
    """Rank 0's answers to 11 volumes (a full and a padded slab of 8)
    against JAX's engine on `make_mesh(data=8)` and the port's one-process
    engine; every other rank followed both slabs."""
    per_rank = _ddp_results(group, f"serve_{kind}_{data}", data)
    got, want = per_rank[0], group[1]["serving"]
    assert got.shape == want["one"][kind].shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want["one"][kind], **sm.SERVE_TOL)
    if kind == "int8":
        assert np.abs(got - want["jax"][kind]).max() <= sm.INT8_JAX_TOL * np.abs(want["jax"][kind]).max()
    else:
        np.testing.assert_allclose(got, want["jax"][kind], **sm.SERVE_TOL)
    assert per_rank[1:] == [2] * (data - 1)


def test_serving_mesh_whose_ranks_all_take_the_first_rows_misses(group):
    got = _ddp_results(group, "serve_first_rows", 4)[0]
    want = group[1]["serving"]["one"]["features"]
    assert not np.allclose(got, want, **sm.SERVE_TOL)


def _mesh_step_results(group, case, data, model):
    got = group[0][case]
    assert sorted(got) == list(range(data)) and all(len(r) == model for r in got.values())
    return [r for d in range(data) for r in got[d]]


@pytest.mark.parametrize("arch", MOCO_ARCHS)
@pytest.mark.parametrize("shape", sm.STEP_MESHES)
def test_moco_step_on_a_model_axis_matches_jax(group, arch, shape):
    """Every rank of the (D, M) mesh against JAX's step on that mesh; the
    parameters and statistics after the step bitwise equal on all D * M
    ranks."""
    per_rank = _mesh_step_results(group, f"mesh_moco_{arch}_{shape[0]}x{shape[1]}", *shape)
    want = group[1]["mesh_moco"][arch][shape]
    for result in per_rank:
        assert md.ddp_gate(result, want, md.MOCO_TOL[arch]) <= 1.0
    for other in per_rank[1:]:
        np.testing.assert_array_equal(other[3], per_rank[0][3])
        for n, b in per_rank[0][2].items():
            np.testing.assert_array_equal(other[2][n], b)


@pytest.mark.parametrize("shape", sm.STEP_MESHES)
def test_contrastive_step_on_a_model_axis_matches_jax(group, shape):
    per_rank = _mesh_step_results(group, f"mesh_contrastive_{shape[0]}x{shape[1]}", *shape)
    want = group[1]["mesh_contrastive"][shape]
    for result in per_rank:
        assert md.ddp_gate(result, want) <= 1.0
    for other in per_rank[1:]:
        np.testing.assert_array_equal(other[3], per_rank[0][3])


@pytest.mark.parametrize("case", ["mesh_moco_world_keys", "mesh_moco_world_grads", "mesh_contrastive_world_grads"])
def test_steps_reducing_over_the_whole_mesh_miss(group, case):
    """The keys gathered, or the gradients summed, over all 4 ranks of the
    (2, 2) mesh instead of its 'data' group miss JAX's (2, 2) step."""
    want = group[1]["mesh_contrastive"][2, 2] if "contrastive" in case else group[1]["mesh_moco"]["vit"][2, 2]
    for result in _mesh_step_results(group, case, 2, 2):
        assert md.ddp_gate(result, want) > 1.0


@pytest.mark.parametrize("case", sm.REPLICA_CASES)
def test_replicas_moved_apart_agree_again(group, case):
    """Gradients moved apart on model coordinate 1 after the data mean:
    `agree_over_model` gives all 4 ranks model coordinate 0's, so the
    parameters after the step are bitwise equal; without it the replicas
    differ."""
    per_rank = _mesh_step_results(group, f"mesh_moco_{case}", 2, 2)
    equal = [np.array_equal(r[3], per_rank[0][3]) for r in per_rank]
    assert equal == ([True] * 4 if case == "apart" else [True, False, True, False])


def test_fsdp_moco_step_on_2x2_matches_jax(group):
    """FSDP over 'data' with the TP rule over 'model' (JAX's
    `shard_moco_state_fsdp` on a (D, M) mesh): two steps against JAX's."""
    results = _mesh_results(group, "mesh_fsdp_moco", 2, 2)
    assert max(fs.moco_gate(r, group[1]["mesh_fsdp_moco"]) for r in results) <= 1.0
    _assert_blocks_agree(results)
    assert any("model" in dims for dims in results[0]["placements"].values())
