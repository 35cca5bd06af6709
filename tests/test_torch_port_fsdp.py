"""The port's sharded training state (parallel/fsdp.py, parallel/tp.py)
against the JAX package's, on the CPU.

In this process:
- `jax_path` inverts the weight bridge on every leaf of the tiny MAE and
  MoCo trees;
- for every leaf of those trees, the port's placement equals JAX's
  `fsdp_param_shardings` (min_size 256, as tests/test_fsdp.py:53) on the
  virtual (8, 1) and (4, 2) meshes and `tp_param_shardings` on (2, 4):
  the same axis on the same dimension, and the same replicated set;
- on the (8, 1) mesh, each data coordinate's block of every leaf, in the
  JAX layout, equals JAX's `addressable_shards` of that device;
- `_fsdp_spec` against JAX's on tests/test_fsdp.py's cases and a tie;
- the refusals, before any collective: `attn_impl` 'auto' and the
  sequence-parallel attention under TP, heads the model axis does not
  divide, FSDP without a data mesh.

The helpers below the line run in the one world of 8 gloo ranks of
tests/test_torch_port_ring_flash.py (rank side) and in its pytest process
(the JAX side), which holds them to each other there, f32 within 1e-5:
- the FSDP MAE step at data = 8 against JAX's `shard_train_state_fsdp`
  step over 2 steps (metrics, the gathered parameters and AdamW moments),
  plain, with `clip_grad` (active) and with `accum_iter = 2`; the control
  with a shard-local clip norm must miss;
- the MoCo ViT FSDP step at data = 4 (f64, LARS, 2 steps) against JAX's
  `shard_moco_state_fsdp` step (loss, both encoders, the LARS traces, the
  statistics); the control with a shard-local trust ratio must miss;
- the TP step on (2, 4) against JAX's `shard_train_state` step on the
  setting of tests/test_tensor_parallel.py:62 (its TINY's depths and 4
  heads, at head dim 32, which the port's per-head wrappers take, and 4
  decoder heads: the port cuts the qkv by heads, and 2 heads do not split
  over 4 ranks; and the contrastive heads), 'flash' in the port (plain on
  the CPU) and 'xla' in JAX; the
  control without Megatron's f (the input gradient's all-reduce) must
  miss;
- FSDP composed with TP on (4, 2) against JAX's;
- the 'flash_ring' MAE step on (2, 4) against JAX's one-device step on
  the global batch (the same function: the ring shards the tokens, not
  the math);
- every replicated leaf bitwise equal across the ranks that hold it, and
  every block across the ranks of the axis it is not cut on; the eval step
  on the sharded model equal, within 1e-6, to one process's on a whole
  copy of it;
- the transport's log (the collectives' tensors, by wrapping
  `torch.distributed` in the rank): FSDP gathers only the blocks of
  'data'-sharded leaves and all-reduces only whole leaves (gloo's
  reduce-scatter), the flat replicated gradients and vectors of
  statistics, never an activation; a TP rank holds a (3C / M, C) qkv
  block and gathers nothing;
- `pretrain-kfold --fsdp` and `moco-kfold --fsdp` through the CLI's parser
  and command on 2 ranks: straight, and resumed across layouts (a data-
  parallel resume file resumed under FSDP, and the other way round).

JAX is imported inside the functions that run it: the ranks import this
module by name and need none of it.
"""

import contextlib
import os
import shutil
from unittest import mock

import numpy as np
import pytest
import torch

from vit_ae_plus_plus_torch.configs import MAEConfig
from vit_ae_plus_plus_torch.models import MODEL_ZOO, build_model
from vit_ae_plus_plus_torch.parallel import Mesh, fsdp, set_mesh, tp
from vit_ae_plus_plus_torch.train import create_train_state, make_adamw, make_train_step
from vit_ae_plus_plus_torch.train.step import make_eval_step
from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax

MIN = 256  # FSDP's leaf-size floor at the tiny sizes (tests/test_fsdp.py:53)
MAE_TINY = "contr_mae_vit_tiny_patch4"
B, VOL, PATCH = 8, 16, 4
LR, EMW, CONTR_W = 1e-3, 0.01, 0.1
CLIP = 0.05  # below the tiny MAE's gradient norm (about 0.3): the clip acts on every step
# tests/test_tensor_parallel.py's TINY (depth 2 and 1, 4 heads), at head dim
# 32 (the per-head and ring wrappers take the kernels' head dims on every
# device), with 4 decoder heads (the port cuts the qkv by heads) and the
# contrastive heads (BatchNorm over 'data' beside a model axis)
TP_CFG = dict(volume_size=VOL, patch_size=PATCH, in_chans=1, embed_dim=128, depth=2, num_heads=4,
              decoder_embed_dim=128, decoder_depth=1, decoder_num_heads=4, contrastive=True)
VARIANTS = ("plain", "clip", "accum")
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fake_mesh(data: int, model: int, d: int = 0, m: int = 0) -> Mesh:
    """The place (d, m) in a (data, model) grid, without process groups: a
    collective on it fails, so what passes ran none."""
    return Mesh(shape={"data": data, "model": model}, coords={"data": d, "model": m},
                ranks={"data": list(range(data)), "model": list(range(model))},
                groups={"data": None, "model": None})


# ------------------------------------------------------------ in this process

def _jax_trees():
    """{tree: (JAX params of the tiny model, the port's model)}: the tiny
    contrastive MAE and the MoCo ViT of tests/test_torch_port_moco_ddp.py."""
    import jax
    import jax.numpy as jnp

    import test_torch_port_moco_ddp as md
    from vit_ae_plus_plus_tpu.models import MODEL_ZOO as JAX_ZOO
    from vit_ae_plus_plus_tpu.models import build_model as jax_build
    from vit_ae_plus_plus_tpu.pipelines import moco_kfold as jmk

    from vit_ae_plus_plus_tpu.configs import DataConfig as JDataConfig
    from vit_ae_plus_plus_torch.configs import DataConfig
    from vit_ae_plus_plus_torch.pipelines import moco_kfold as tmk

    x = jnp.zeros((2, 1, VOL, VOL, VOL))
    mae = jax_build(JAX_ZOO[MAE_TINY](volume_size=VOL, dtype="float32"))
    mae_params = jax.eval_shape(mae.init, {"params": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(2)}, x, x)
    moco = jmk.build_moco_model(JDataConfig(volume_size=VOL), "float32", "vit", **md.MOCO)
    moco_params = jax.eval_shape(lambda k: moco.init(k, x, use_predictor=True), {"params": jax.random.PRNGKey(0)})
    port_mae = build_model(MODEL_ZOO[MAE_TINY](volume_size=VOL, dtype="float32"))
    port_moco = tmk.build_moco_model(DataConfig(volume_size=VOL), "float32", "vit", **md.MOCO)
    return {"mae": (mae_params["params"], port_mae), "moco": (moco_params["params"], port_moco)}


@pytest.fixture(scope="module")
def trees():
    return _jax_trees()


def _jax_leaves(params):
    """(path as strings, leaf) of a JAX tree."""
    import jax

    return [(tuple(str(getattr(k, "key", k)) for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]]


def _bridge_name(path, leaf, moco):
    """The port's name of a JAX leaf, through the weight bridge."""
    tree = {"trunk": {}, "projector": {}, "predictor": {}} if moco else {}
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = np.zeros(leaf.shape, np.float32)
    (name,) = params_from_jax(tree, PATCH, 1)
    return name


@pytest.mark.parametrize("which", ["mae", "moco"])
def test_jax_path_inverts_the_weight_bridge(trees, which):
    params, model = trees[which]
    named = dict(model.named_parameters())
    leaves = _jax_leaves(params)
    assert len(leaves) == len(named)
    for path, leaf in leaves:
        name = _bridge_name(path, leaf, which == "moco")
        assert tp.jax_path(name, named[name].ndim, which == "moco") == path, name
        assert tp.jax_shape(path, named[name].shape) == tuple(leaf.shape) or "patch_embed" in path


MESHES = {"fsdp_8x1": (8, 1), "fsdp_4x2": (4, 2), "tp_2x4": (2, 4)}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("which", ["mae", "moco"])
def test_placements_equal_jax(trees, which, mesh_name):
    """The same axis on the same JAX dimension for every leaf, hence the
    same replicated set."""
    import jax

    from vit_ae_plus_plus_tpu.parallel import make_mesh as jax_mesh
    from vit_ae_plus_plus_tpu.parallel.fsdp import fsdp_param_shardings as jax_fsdp
    from vit_ae_plus_plus_tpu.parallel.tp import tp_param_shardings as jax_tp

    params, model = trees[which]
    data, model_axis = MESHES[mesh_name]
    jmesh = jax_mesh(data=data, model=model_axis, devices=jax.devices()[:8])
    if mesh_name.startswith("tp"):
        want_tree, got = jax_tp(params, jmesh), tp.tp_param_shardings(model, fake_mesh(data, model_axis))
    else:
        want_tree = jax_fsdp(params, jmesh, min_size=MIN)
        got = fsdp.fsdp_param_shardings(model, fake_mesh(data, model_axis), MIN)
    want = {}
    for (path, leaf), (_, sharding) in zip(_jax_leaves(params), _jax_leaves(want_tree)):
        spec = list(sharding.spec)
        while spec and spec[-1] is None:
            spec.pop()
        want[_bridge_name(path, leaf, which == "moco")] = tuple(spec)
    assert got == want
    replicated = {n for n, s in got.items() if not s}
    assert replicated == {n for n, s in want.items() if not s} and len(replicated) < len(got)


def _to_jax_layout(name, t):
    return t.T if t.ndim == 2 else t


@pytest.mark.parametrize("which", ["mae", "moco"])
def test_blocks_equal_jax_addressable_shards(trees, which):
    """Each data coordinate's block of every leaf of seeded values, in the
    JAX layout, is JAX's shard on that device of the (8, 1) mesh."""
    import jax
    import jax.numpy as jnp

    from vit_ae_plus_plus_tpu.parallel import make_mesh as jax_mesh
    from vit_ae_plus_plus_tpu.parallel.fsdp import fsdp_param_shardings as jax_fsdp

    params, model = trees[which]
    rng = np.random.default_rng(7)
    values = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), params)
    jmesh = jax_mesh(data=8, devices=jax.devices()[:8])
    placed = jax.tree.map(jax.device_put, jax.tree.map(jnp.asarray, values), jax_fsdp(params, jmesh, min_size=MIN))
    specs = fsdp.fsdp_param_shardings(model, fake_mesh(8, 1), MIN)
    moco = which == "moco"
    devices = list(jmesh.devices.flat)
    sharded = 0
    for (path, leaf), (_, arr) in zip(_jax_leaves(values), _jax_leaves(placed)):
        name = _bridge_name(path, leaf, moco)
        if "patch_embed" in path and path[-1] == "kernel":
            assert not specs[name]
            continue
        ndim = len(leaf.shape)
        dims = tp.torch_dims(path, ndim, specs[name])
        full = torch.from_numpy(np.ascontiguousarray(_to_jax_layout(name, leaf) if path[-1] == "kernel" else leaf))
        sharded += bool(dims)
        for shard in arr.addressable_shards:
            d = devices.index(shard.device)
            block = tp.local_block(name, full, dims, fake_mesh(8, 1, d))
            got = _to_jax_layout(name, block.numpy()) if path[-1] == "kernel" else block.numpy()
            np.testing.assert_array_equal(got, np.asarray(shard.data), err_msg=f"{name} on device {d}")
    assert sharded > 0


@pytest.mark.parametrize("base,shape,data,want", [
    ((), (256, 1024), 8, (None, "data")),
    ((None, "model"), (256, 1024), 8, ("data", "model")),
    ((), (7, 13), 8, ()),
    ((), (32,), 8, ()),
    ((), (768, 768), 4, ("data",)),  # a tie: the first dimension in JAX order
])
def test_fsdp_spec_equals_jax(base, shape, data, want):
    from jax.sharding import PartitionSpec as P

    from vit_ae_plus_plus_tpu.parallel.fsdp import _fsdp_spec as jax_spec

    min_size = 8192 if shape == (32,) else 1
    assert fsdp._fsdp_spec(base, shape, data, min_size) == want
    assert tuple(jax_spec(P(*base), shape, data, min_size)) == want


def _tiny_state(attn_impl="flash", cfg=TP_CFG):
    model = build_model(MAEConfig(**cfg, attn_impl=attn_impl))
    return create_train_state(model, make_adamw(LR))


@pytest.mark.parametrize("attn_impl,match", [("auto", "tensor-parallel"), ("flash_ring", "pick one"),
                                             ("flash_seq", "pick one")])
def test_tp_refuses_what_it_cannot_shard_before_any_collective(attn_impl, match):
    state = _tiny_state(attn_impl)
    before = {n: p.clone() for n, p in state.model.named_parameters()}
    with pytest.raises(ValueError, match=match):
        tp.shard_train_state(state, fake_mesh(2, 4))
    assert all(torch.equal(before[n], p) for n, p in state.model.named_parameters())


@pytest.mark.parametrize("which", ["tp", "fsdp"])
def test_heads_that_the_model_axis_does_not_divide_are_refused(which):
    state = _tiny_state("flash", {**TP_CFG, "decoder_num_heads": 2})
    with pytest.raises(ValueError, match="2 heads do not split over a model axis of 4"):
        if which == "tp":
            tp.shard_train_state(state, fake_mesh(2, 4))
        else:
            fsdp.shard_train_state_fsdp(state, fake_mesh(2, 4), MIN)


@pytest.mark.parametrize("mesh", [None, (1, 1), (1, 4)], ids=["no_mesh", "data_1", "data_1_model_4"])
def test_fsdp_needs_a_data_mesh(mesh):
    state = _tiny_state()
    with pytest.raises(ValueError, match=r"--fsdp needs a data mesh \(--n-devices > 1\)"):
        fsdp.shard_train_state_fsdp(state, None if mesh is None else fake_mesh(*mesh), MIN)


def test_a_sharded_unit_refuses_to_run_without_its_mesh():
    """A block whose leaves are blocks of a 'data' sharding cannot run
    outside its mesh."""
    state = _tiny_state("plain")
    fsdp.shard_train_state_fsdp(state, fake_mesh(2, 1), MIN)
    assert state.model.blocks[0].fsdp
    x = torch.zeros(1, 5, TP_CFG["embed_dim"])
    with pytest.raises(RuntimeError, match="run it under its mesh"):
        state.model.blocks[0](x)


# ------------------------------- the ranks' side of the 8-rank world, and JAX's

def views():
    """The global batch's two views and the masking noise of its 2B rows."""
    rng = np.random.default_rng(23)
    v1, v2 = (rng.standard_normal((B, 1, VOL, VOL, VOL)).astype(np.float32) for _ in range(2))
    return v1, v2, rng.random((2 * B, (VOL // PATCH) ** 3)).astype(np.float32)


def _randomised(shapes, seed):
    """f32 values for the leaves of a `jax.eval_shape` of an init: scales
    and variances near 1, the rest small."""
    import jax

    rng = np.random.default_rng(seed)

    def leaf(path, x):
        key = jax.tree_util.keystr(path)
        if key.endswith("['scale']") or key.endswith("['var']"):
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_mae(cfg):
    from vit_ae_plus_plus_tpu.configs import MAEConfig as JaxMAEConfig
    from vit_ae_plus_plus_tpu.models import MODEL_ZOO as JAX_ZOO
    from vit_ae_plus_plus_tpu.models import build_model as jax_build

    if cfg is None:
        return jax_build(JAX_ZOO[MAE_TINY](volume_size=VOL, dtype="float32"))
    return jax_build(JaxMAEConfig(**cfg, attn_impl="xla"))


def jax_weights(cfg=None, seed=3):
    """(params, batch_stats) as numpy of the tiny contrastive MAE (cfg None)
    or of an MAEConfig's keywords."""
    import jax
    import jax.numpy as jnp

    v1, v2, _ = views()
    variables = _randomised(jax.eval_shape(_jax_mae(cfg).init, {"params": jax.random.PRNGKey(1),
                                                                "mask": jax.random.PRNGKey(2)},
                                           jnp.asarray(v1[:2]), jnp.asarray(v2[:2])), seed)
    return variables["params"], variables.get("batch_stats", {})


def _adam_moments(opt_state):
    import jax
    import optax

    (found,) = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
                if isinstance(s, optax.ScaleByAdamState)]
    return found.mu, found.nu


def _named(tree, stats=None):
    import jax

    return {n: t.numpy() for n, t in params_from_jax(jax.tree.map(np.asarray, jax.device_get(tree)), PATCH, 1,
                                                    stats).items()}


def jax_mae_run(weights, cfg=None, kind="fsdp", data=8, model_axis=1, variant="plain", steps=2):
    """JAX `make_train_step` on a (data, model_axis) mesh with the state
    placed by `kind` ('fsdp': `shard_train_state_fsdp`; 'tp':
    `shard_train_state`; 'replicated') and the global batch's noise
    injected, `steps` steps -> (each step's metrics, the parameters, mu,
    nu, the batch_stats) under the port's names."""
    import jax
    import jax.numpy as jnp

    from vit_ae_plus_plus_tpu.parallel import make_mesh as jax_mesh
    from vit_ae_plus_plus_tpu.parallel.fsdp import shard_train_state_fsdp as jax_fsdp
    from vit_ae_plus_plus_tpu.parallel.tp import shard_train_state as jax_tp
    from vit_ae_plus_plus_tpu.train import TrainState as JaxTrainState
    from vit_ae_plus_plus_tpu.train import make_adamw as jax_adamw
    from vit_ae_plus_plus_tpu.train import make_train_step as jax_train_step

    params, bs = weights
    model = _jax_mae(cfg)
    v1, v2, noise = views()
    contrastive = model.cfg.contrastive

    def forward(variables, a, b, _rng):
        if not contrastive:
            return model.apply(variables, a, None, mask_ratio=0.75, noise=jnp.asarray(noise[:B])), None
        out, mutated = model.apply(variables, a, b, mask_ratio=0.75, noise=jnp.asarray(noise),
                                   mutable=["batch_stats"])
        return out, mutated["batch_stats"]

    tx = jax_adamw(LR, clip_grad=CLIP if variant == "clip" else None, accum_iter=2 if variant == "accum" else 1)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, params),
                          batch_stats=jax.tree.map(jnp.asarray, bs), opt_state=tx.init(params), tx=tx)
    mesh = jax_mesh(data=data, model=model_axis, devices=jax.devices()[:data * model_axis])
    shardings = None
    if kind == "fsdp":
        state, shardings = jax_fsdp(state, mesh, min_size=MIN)
    elif kind == "tp":
        state = jax_tp(state, mesh)
    step = jax_train_step(model, PATCH, contr_weight=CONTR_W if contrastive else 0.0, forward_fn=forward,
                          donate=False, mesh=mesh, state_shardings=shardings)
    metrics = []
    with jax.set_mesh(mesh):
        for _ in range(steps):
            state, m = step(state, jnp.asarray(v1), jnp.asarray(v2), jax.random.PRNGKey(0), jnp.float32(EMW))
            metrics.append({k: float(v) for k, v in m.items()})
    mu, nu = _adam_moments(state.opt_state)
    return {"metrics": metrics, "params": _named(state.params), "mu": _named(mu), "nu": _named(nu),
            "stats": {k: v for k, v in _named(state.params, state.batch_stats).items()
                      if k.endswith(("running_mean", "running_var"))}}


def with_floor(want, other):
    """`want` (a `jax_mae_run`) with `floor`: each parameter's largest
    difference (`_held`) from `other`, JAX's step on the same weights in
    another layout: JAX's own spread under another summation order."""
    want["floor"] = {n: float(np.abs(_held("params", n, w - other["params"][n])).max())
                     for n, w in want["params"].items()}
    return want


@contextlib.contextmanager
def transport_log(mesh):
    """{"all_gather": [(axis, source shape)], "all_reduce": [(axis, shape)]}
    of the collectives this rank issues over `mesh`'s axes while open
    (torch.distributed wrapped where the port's transport calls it)."""
    from vit_ae_plus_plus_torch.parallel import mesh as transport

    log = {"all_gather": [], "all_reduce": []}
    gather, reduce = transport.dist.all_gather, transport.dist.all_reduce
    axis_of = {id(g): axis for axis, g in mesh.groups.items() if g is not None}

    def all_gather(parts, src, *a, group=None, **k):
        log["all_gather"].append((axis_of.get(id(group)), tuple(src.shape)))
        return gather(parts, src, *a, group=group, **k)

    def all_reduce(t, *a, group=None, **k):
        log["all_reduce"].append((axis_of.get(id(group)), tuple(t.shape)))
        return reduce(t, *a, group=group, **k)

    with mock.patch.object(transport.dist, "all_gather", all_gather), \
            mock.patch.object(transport.dist, "all_reduce", all_reduce):
        yield log


def control(name):
    """The controls that must miss: 'clip_local', the clip's norm over this
    rank's blocks; 'lars_local', LARS's trust ratio from this rank's
    blocks; 'tp_no_f', TP without the all-reduce of the column-parallel
    input's gradient."""
    from vit_ae_plus_plus_torch.train import optim

    if name == "clip_local":
        real = optim.global_norm
        return mock.patch.object(optim, "global_norm", lambda ts, axes=None: real(ts))
    if name == "lars_local":
        real = optim.leaf_norms
        return mock.patch.object(optim, "leaf_norms", lambda ts, axes=None: real(ts))
    if name == "tp_no_f":
        return mock.patch.object(tp._CopyToModel, "backward", staticmethod(lambda ctx, g: (g, None)))
    return contextlib.nullcontext()


def _moments(tx, mesh):
    """The AdamW moments, whole, under the parameters' names."""
    mu, nu = {}, {}
    for name, p in zip(tx.names, tx.params):
        st = tx.opt.state[p]
        dims = tx.placements.get(name, {})
        mu[name] = tp.whole(name, st["exp_avg"], dims, mesh).numpy().copy()
        nu[name] = tp.whole(name, st["exp_avg_sq"], dims, mesh).numpy().copy()
    return mu, nu


def run_mae(mesh, weights, cfg=None, kind="fsdp", variant="plain", control_name=None, attn_impl="auto",
            steps=2):
    """`steps` steps of the port's MAE on this rank's rows of the global
    batch under `mesh`, the state placed by `kind` ('fsdp', 'tp', or
    'replicated' for a sequence-parallel trunk) -> each step's metrics, the
    parameters and moments whole, the statistics, this rank's own tensors
    (its blocks and replicated leaves), the placements, the transport's
    log."""
    params, bs = weights
    model_cfg = MODEL_ZOO[MAE_TINY](volume_size=VOL, dtype="float32", attn_impl=attn_impl) if cfg is None \
        else MAEConfig(**cfg, attn_impl=attn_impl)
    model = build_model(model_cfg)
    model.load_state_dict(params_from_jax(params, PATCH, 1, bs), strict=True)
    tx = make_adamw(LR, clip_grad=CLIP if variant == "clip" else None, accum_iter=2 if variant == "accum" else 1)
    state = create_train_state(model, tx)
    if kind == "fsdp":
        state, _ = fsdp.shard_train_state_fsdp(state, mesh, MIN)
    elif kind == "tp":
        state = tp.shard_train_state(state, mesh)
    v1, v2, noise = views()
    d, b = mesh.coords["data"], B // mesh.size("data")
    rows = slice(d * b, (d + 1) * b)
    mine = torch.from_numpy(np.concatenate([noise[:B][rows], noise[B:][rows]])
                            if model_cfg.contrastive else noise[:B][rows])
    step = make_train_step(model, PATCH, contr_weight=CONTR_W if model_cfg.contrastive else 0.0,
                           forward_fn=lambda m, a, c, _g: m(a, c, noise=mine))
    metrics = []
    with set_mesh(mesh), control(control_name):
        with transport_log(mesh) as log:
            for _ in range(steps):
                state, m = step(state, torch.from_numpy(v1[rows]), torch.from_numpy(v2[rows]), EMW)
                metrics.append({k: float(v) for k, v in m.items()})
        mu, nu = _moments(state.tx, mesh)
        whole = fsdp.full_state_dict(model)
        evaluate = make_eval_step(model, PATCH)
        rows_noise = mine[:b]
        sharded_eval = evaluate(model, torch.from_numpy(v1[rows]), noise=rows_noise)
    # the same evaluation in one process, on a whole copy of the stepped model
    one = build_model(model_cfg)
    one.load_state_dict(whole, strict=True)
    one_eval = make_eval_step(one, PATCH)(one, torch.from_numpy(v1[rows]), noise=rows_noise)
    return {"eval": {k: (float(sharded_eval[k]), float(one_eval[k])) for k in one_eval},
            "metrics": metrics, "params": {n: whole[n].numpy().copy() for n, _ in model.named_parameters()},
            "mu": mu, "nu": nu, "stats": {n: v.numpy().copy() for n, v in whole.items()
                                          if n.endswith(("running_mean", "running_var"))},
            "local": {n: p.detach().numpy().copy() for n, p in model.named_parameters()},
            "placements": getattr(model, "placements", {}), "log": log,
            "coords": (mesh.coords["data"], mesh.coords["model"]), "mesh": (mesh.size("data"), mesh.size("model"))}


def _held(kind, name, a):
    """The elements of a leaf that the parameter gate holds: all but the key
    third of a qkv bias. Softmax is invariant to a key bias, so its
    gradient is zero in exact arithmetic and rounding noise here (mu about
    1e-11 against 1e-4 on the query bias); Adam divides that noise by its
    own root mean square, and the update reads its sign: 6.1e-5 of the
    largest parameter at TP's setting, in JAX's own TP step against its
    data-parallel step as much (JAX's tests/test_tensor_parallel.py holds
    the parameters at 1e-3 for this reason). Those rows' moments stay in
    the mu and nu gates."""
    if kind == "params" and name.endswith("attn.qkv.bias"):
        c = a.shape[0] // 3
        return np.concatenate([a[:c], a[2 * c:]])
    return a


# the parameters after two AdamW steps against JAX's: Adam divides each
# gradient by its own root mean square, so where a gradient is near
# Adam's eps (1e-8) its summation order moves the update. On a model axis,
# where the gradients into the trunk sum over the model ranks, JAX's own
# TP step against its data-parallel step on the same weights reads 1.34
# times 1e-5 of the largest parameter on the patch embed. So there each
# parameter is held to 1e-5 of the largest parameter or FLOOR_FACTOR times
# JAX's own spread on it (`with_floor`: against JAX's one-device step),
# whichever is larger; on a data mesh (FSDP, the ring's reference) to 1e-5
FLOOR_FACTOR = 4


def mae_gate(got, want, tol=TOL) -> float:
    """The largest reading over its limit, at most 1 inside the gate: each
    step's metrics relative (1e-5 of the value, 1e-7 absolute), mu's and
    nu's largest error over 1e-5 of the kind's largest magnitude across
    leaves, each parameter's (`_held`) over the larger of that and
    FLOOR_FACTOR times JAX's own spread (`want["floor"]`, where given),
    the statistics 1e-6."""
    ratios = [abs(g[k] - w[k]) / (tol * abs(w[k]) + 1e-7) for g, w in zip(got["metrics"], want["metrics"])
              for k in w]
    for kind in ("params", "mu", "nu"):
        assert set(got[kind]) == set(want[kind]), kind
        top = max(np.abs(w).max() for w in want[kind].values())
        floor = want.get("floor", {}) if kind == "params" else {}
        ratios += [np.abs(_held(kind, n, got[kind][n] - w)).max() / max(tol * top, FLOOR_FACTOR * floor.get(n, 0.0))
                   for n, w in want[kind].items()]
    ratios += [np.abs(got["stats"][n] - w).max() / 1e-6 for n, w in want["stats"].items()]
    return float(max(ratios))


def jax_moco_fsdp(weights, data=4, steps=2, model_axis=1, vit=None):
    """JAX `make_moco_train_step` with LARS on the state of
    `shard_moco_state_fsdp` over a (data, model) mesh, f64 (the trunk
    `md.VIT`, or `vit`) -> (each step's loss, the base and momentum leaves,
    the LARS traces, the statistics)."""
    import jax
    import jax.numpy as jnp
    import optax

    import test_torch_port_moco_ddp as md
    from vit_ae_plus_plus_tpu.parallel import make_mesh as jax_mesh
    from vit_ae_plus_plus_tpu.parallel.fsdp import shard_moco_state_fsdp as jax_shard
    from vit_ae_plus_plus_tpu.pipelines import moco_kfold as jmk
    from vit_ae_plus_plus_tpu.train.optim import make_lars as jax_lars

    x1, x2 = md.moco_views()
    base, mom = weights["base"], weights["momentum"]
    with md.x64():
        model = md._jax_moco_model("vit", vit)
        tx = jax_lars(md.MOCO_LR)
        copy = lambda tree: jax.tree.map(jnp.array, tree)  # noqa: E731
        state = jmk.MoCoState(step=jnp.zeros((), jnp.int32), params=copy(base["params"]),
                              batch_stats=copy(base["batch_stats"]), momentum_params=copy(mom["params"]),
                              momentum_batch_stats=copy(mom["batch_stats"]), opt_state=tx.init(base["params"]),
                              tx=tx)
        mesh = jax_mesh(data=data, model=model_axis, devices=jax.devices()[:data * model_axis])
        state, shardings = jax_shard(state, mesh, min_size=MIN)
        step = jmk.make_moco_train_step(model, mesh=mesh, state_shardings=shardings)
        losses = []
        for _ in range(steps):
            state, metrics = step(state, jnp.asarray(x1), jnp.asarray(x2), jnp.float32(md.MOCO_M))
            losses.append(float(metrics["loss"]))
        state = jax.device_get(state)
        (trace,) = [s for s in jax.tree.leaves(state.opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState))
                    if isinstance(s, optax.TraceState)]
    named = lambda tree, stats=None: {k: v.numpy() for k, v in params_from_jax(  # noqa: E731
        jax.tree.map(np.asarray, tree), PATCH, 1, stats).items()}
    base_sd = named(state.params, state.batch_stats)
    mom_sd = named(state.momentum_params, state.momentum_batch_stats)
    return {"losses": losses, "base": base_sd,
            "momentum": {k[len("base_encoder."):]: v for k, v in mom_sd.items() if k.startswith("base_encoder.")},
            "trace": named(trace.trace)}


def run_moco(mesh, weights, control_name=None, steps=2, vit=None):
    """The port's MoCo ViT step (f64, LARS; the trunk `md.VIT`, or `vit`)
    with the FSDP state over `mesh` on this rank's rows, `steps` steps -> as
    `jax_moco_fsdp`, and the rank's own tensors."""
    import test_torch_port_moco_ddp as md
    from vit_ae_plus_plus_torch.pipelines import moco_kfold as tmk
    from vit_ae_plus_plus_torch.train.optim import make_lars

    model = md._port_moco("vit", weights["base"], vit)
    mom = md._port_moco("vit", weights["momentum"], vit).base_encoder
    state = tmk.create_moco_state(model, make_lars(md.MOCO_LR))
    state.momentum_encoder.load_state_dict(mom.state_dict(), strict=True)
    state, _ = fsdp.shard_moco_state_fsdp(state, mesh, MIN)
    x1, x2 = (torch.from_numpy(md._rows(mesh, x)) for x in md.moco_views())
    step = tmk.make_moco_train_step(model)
    losses = []
    with set_mesh(mesh), control(control_name):
        with transport_log(mesh) as log:
            for _ in range(steps):
                state, metrics = step(state, x1, x2, md.MOCO_M)
                losses.append(float(metrics["loss"]))
        base = fsdp.full_state_dict(model)
        momentum = fsdp.full_state_dict(state.momentum_encoder)
        trace = {n: tp.whole(n, state.tx.opt.state[p]["trace"], state.tx.placements.get(n, {}), mesh)
                 for n, p in zip(state.tx.names, state.tx.params)}
    as_np = lambda sd: {k: v.numpy().copy() for k, v in sd.items()}  # noqa: E731
    return {"losses": losses, "base": as_np(base), "momentum": as_np(momentum), "trace": as_np(trace),
            "local": {n: p.detach().numpy().copy() for n, p in model.named_parameters()},
            "placements": model.placements, "log": log, "coords": (mesh.coords["data"], mesh.coords["model"]),
            "mesh": (mesh.size("data"), mesh.size("model"))}


def moco_gate(got, want, tol=1e-9) -> float:
    """f64 on both sides: the losses, every leaf of both encoders and the
    traces within `tol` of the kind's largest magnitude."""
    ratios = [abs(g - w) / (tol * abs(w)) for g, w in zip(got["losses"], want["losses"])]
    for kind in ("base", "momentum", "trace"):
        assert set(want[kind]) <= set(got[kind]), kind
        top = max(np.abs(w).max() for w in want[kind].values())
        ratios += [np.abs(got[kind][n] - w).max() / (tol * top) for n, w in want[kind].items()]
    return float(max(ratios))


# ------------------------------------------------- the CLI on two ranks

def _cli(argv, mesh):
    from vit_ae_plus_plus_torch import cli

    with set_mesh(mesh):
        return cli.command(cli.build_parser().parse_args(argv))


def _set_aside_features(work, mesh):
    """Rename the features so that a resumed run trains its folds again."""
    from vit_ae_plus_plus_torch.parallel import barrier

    barrier(mesh)
    if mesh.coords["data"] == 0:
        feat_dir = os.path.join(work, "ssl_features_dir")
        shutil.move(feat_dir, feat_dir + ".first")
    barrier(mesh)


@contextlib.contextmanager
def small_leaves_sharded():
    """FSDP's floor at MIN in the rank, so that the tiny trunks shard."""
    with mock.patch.object(fsdp, "_MIN_SHARD_ELEMENTS", MIN):
        yield


def run_cli_pretrain(mesh, data_dir, root):
    """`pretrain-kfold` on 2 ranks through the CLI's parser and command:
    --fsdp for 2 epochs (A); data parallel for 1 epoch, then resumed for 2
    under --fsdp (B); --fsdp for 1 epoch, then resumed for 2 data parallel
    (C). The warmup is longer than the run and the edge weight of epoch 0
    is 0.01 whatever the epoch count, so B and C train what A does. ->
    {run: results}."""
    from vit_ae_plus_plus_torch.pipelines import pretrain_kfold

    common = ["pretrain-kfold", "--data-path", data_dir, "--model", MAE_TINY, "--volume-size", str(VOL),
              "--patch-size", str(PATCH), "--n-splits", "2", "--batch-size", "4", "--compute-dtype", "float32",
              "--resume", "--n-devices", "2", "--device", "cpu"]
    out = {}
    # no host augmentation: a resumed run draws it afresh (ROADMAP Queue 3), as
    # tests/test_torch_port_pretrain_resume.py's kills and resumes do
    with mock.patch.object(pretrain_kfold, "default_ssl_transforms", lambda: None), small_leaves_sharded():
        out["A"] = _cli(common + ["--work-dir", os.path.join(root, "A"), "--epochs", "2", "--fsdp"], mesh)
        for run, first, second in (("B", [], ["--fsdp"]), ("C", ["--fsdp"], [])):
            work = os.path.join(root, run)
            _cli(common + ["--work-dir", work, "--epochs", "1", *first], mesh)
            _set_aside_features(work, mesh)
            out[run] = _cli(common + ["--work-dir", work, "--epochs", "2", *second], mesh)
    return out


def run_cli_moco(mesh, data_dir, root):
    """`moco-kfold` on 2 ranks through the CLI's parser and command, the ViT
    trunk at tests/test_torch_port_moco_ddp.py's width: --fsdp (A), then
    resumed data parallel after its features were set aside (A'); data
    parallel (D), then resumed under --fsdp (D'). A resumed fold restores
    its last epoch, trains no more and extracts again. -> {run: results}."""
    import test_torch_port_moco_ddp as md
    from vit_ae_plus_plus_torch.data import transforms as tt
    from vit_ae_plus_plus_torch.pipelines import moco_kfold as tmk

    build = tmk.build_moco_model

    def tiny(data_cfg, dtype, arch, depth, dim, mlp_dim, overrides=None):
        return build(data_cfg, dtype, arch, depth, md.DIM, md.MLP_DIM, md.VIT)

    common = ["moco-kfold", "--data-path", data_dir, "--volume-size", str(VOL), "--n-splits", "2",
              "--batch-size", "4", "--epochs", "2", "--compute-dtype", "float32", "--seed", "3", "--resume",
              "--n-devices", "2", "--device", "cpu"]
    out = {}
    with small_leaves_sharded(), mock.patch.object(tmk, "build_moco_model", tiny), \
            mock.patch.object(tmk, "default_ssl_transforms", lambda: tt.default_ssl_transforms(native="never")):
        for run, first, second in (("A", ["--fsdp"], []), ("D", [], ["--fsdp"])):
            work = os.path.join(root, f"moco_{run}")
            out[run] = _cli(common + ["--work-dir", work, *first], mesh)
            _set_aside_features(work, mesh)
            out[run + "'"] = _cli(common + ["--work-dir", work, *second], mesh)
    return out
