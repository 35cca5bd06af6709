"""The training step and the data-parallel launch on a mesh's 'data' axis,
in one process.

The JAX step (vit_ae_plus_plus_tpu/train/step.py) shards the batch over
'data' and so takes the gradient and the contrastive BatchNorm's statistics
over the global batch. The port's step does the same on a mesh of (D, 1):
those cases need a process group, so they run in the 8-rank world of
tests/test_torch_port_ring_flash.py (against JAX's data-mesh step). Here:

- as in the JAX package, a mesh with a model axis > 1 refuses
  `attn_impl='auto'` (the packed kernel) before any forward, and the
  refusal changes nothing; a mesh of data = 1 and no mesh at all train as
  before (on (1, 4) with 'plain': the trunk replicated over 'model'). These
  meshes are built directly, with no process group: the step must decide
  from the mesh's shape alone. The (D, M > 1) steps themselves (TP, FSDP
  with TP, 'flash_ring') run in the 8-rank world of
  tests/test_torch_port_ring_flash.py.
- the masking noise drawn from the generator under a (D, 1) mesh: each
  data coordinate's rows of the global batch's noise, for both views, so
  the masks are the one-process run's rows (the model in eval mode: its
  BatchNorm reads its running statistics and reduces over no group).
- the NCCL launch refuses more ranks than visible cards before any spawn,
  through `run_ranks` and the CLI's `--n-devices`, and the CLI refuses a
  batch size the ranks do not divide before any spawn.
"""

import numpy as np
import pytest
import torch

from vit_ae_plus_plus_torch import cli
from vit_ae_plus_plus_torch.configs import MAEConfig
from vit_ae_plus_plus_torch.models import build_model
from vit_ae_plus_plus_torch.parallel import Mesh, run_ranks, set_mesh
from vit_ae_plus_plus_torch.train import create_train_state, make_adamw, make_train_step

B, VOL, PATCH = 2, 16, 4
TINY = dict(volume_size=VOL, patch_size=PATCH, embed_dim=24, depth=1, num_heads=3,
            decoder_embed_dim=12, decoder_depth=1, decoder_num_heads=2,
            in_chans=1, contrastive=True, use_proj=False, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(data: int, model: int, d: int = 0) -> Mesh:
    """The place (d, 0) in a (data, model) grid, without process groups."""
    return Mesh(shape={"data": data, "model": model}, coords={"data": d, "model": 0},
                ranks={"data": [m * model for m in range(data)], "model": list(range(model))},
                groups={"data": None, "model": None})


def _step_and_state(attn_impl="auto"):
    torch.manual_seed(0)
    model = build_model(MAEConfig(**TINY, attn_impl=attn_impl))
    state = create_train_state(model, make_adamw(1e-3))
    calls = []
    rng = np.random.default_rng(3)
    noise = torch.from_numpy(rng.random((2 * B, (VOL // PATCH) ** 3)).astype(np.float32))

    def forward_fn(m, v1, v2, _generator):
        calls.append(1)
        return m(v1, v2, noise=noise)

    step = make_train_step(model, PATCH, contr_weight=0.1, forward_fn=forward_fn)
    v1, v2 = (torch.from_numpy(rng.standard_normal((B, 1, VOL, VOL, VOL)).astype(np.float32)) for _ in range(2))
    return step, state, calls, v1, v2


@pytest.mark.parametrize("data,model", [(2, 4), (4, 2)])
def test_step_refuses_a_data_axis_before_any_forward(data, model):
    """A model axis > 1 with attn_impl='auto': the packed kernel holds whole
    heads of q, k and v, so the JAX package refuses it under a model axis
    (tests/test_tensor_parallel.py:21), and so does the port."""
    step, state, calls, v1, v2 = _step_and_state()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    with set_mesh(_mesh(data, model)), pytest.raises(ValueError, match="tensor-parallel"):
        step(state, v1, v2, 0.01)
    assert calls == [] and state.step == 0
    after = state.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


@pytest.mark.parametrize("mesh", [None, (1, 1), (1, 4)], ids=["no_mesh", "mesh_1x1", "mesh_1x4"])
def test_step_trains_without_a_data_axis(mesh):
    # on (1, 4) the packed 'auto' is refused (above): the replicated trunk with 'plain'
    step, state, calls, v1, v2 = _step_and_state("plain" if mesh == (1, 4) else "auto")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    with set_mesh(None if mesh is None else _mesh(*mesh)):
        state, metrics = step(state, v1, v2, 0.01)
    assert calls == [1] and state.step == 1
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    after = state.model.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)


def test_a_refused_step_leaves_the_next_step_on_no_mesh_equal_to_a_fresh_one():
    """The refusal changes nothing: a step taken afterwards without the mesh
    gives the parameters of a step taken without ever trying."""
    step, state, _, v1, v2 = _step_and_state()
    with set_mesh(_mesh(2, 4)), pytest.raises(ValueError):
        step(state, v1, v2, 0.01)
    state, _ = step(state, v1, v2, 0.01)
    step2, fresh, _, w1, w2 = _step_and_state()
    fresh, _ = step2(fresh, w1, w2, 0.01)
    got, want = state.model.state_dict(), fresh.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("data", [2, 4])
@pytest.mark.parametrize("contrastive", [True, False], ids=["contrastive", "plain"])
def test_generator_noise_follows_the_global_batch(data, contrastive):
    """Each data coordinate's masks are its volumes' rows of the one-process
    masks of the global batch, for both views; the generator moves alike on
    every coordinate."""
    model = build_model(MAEConfig(**{**TINY, "contrastive": contrastive})).eval()
    rng = np.random.default_rng(4)
    v1, v2 = (torch.from_numpy(rng.standard_normal((8, 1, VOL, VOL, VOL)).astype(np.float32)) for _ in range(2))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        want = model(v1, v2, generator=gen)
        after = torch.rand(1, generator=gen)
    b = 8 // data
    for d in range(data):
        gen = torch.Generator().manual_seed(5)
        rows = slice(d * b, (d + 1) * b)
        with set_mesh(_mesh(data, 1, d)), torch.no_grad():
            got = model(v1[rows], v2[rows], generator=gen)
        np.testing.assert_array_equal(got["mask"].numpy(), want["mask"][rows].numpy())
        if contrastive:  # view 2's encoded tokens, masked by its own rows of the noise
            np.testing.assert_allclose(got["z2"].reshape(b, -1, 24).numpy(),
                                       want["z2"].reshape(8, -1, 24)[rows].numpy(), rtol=1e-5, atol=1e-6)
        assert torch.equal(torch.rand(1, generator=gen), after)


def test_nccl_launch_refuses_more_ranks_than_cards(tmp_path):
    """No spawn, no store, no fall-back to gloo: NCCL takes one card a rank
    (this machine sees none)."""
    store = tmp_path / "store"
    with pytest.raises(RuntimeError, match="2 NCCL ranks need 2 CUDA devices"):
        run_ranks(print, 2, store_dir=str(store), backend="nccl")
    assert not store.exists()
    with pytest.raises(ValueError, match="backend"):
        run_ranks(print, 2, store_dir=str(store), backend="mpi")


@pytest.mark.parametrize("cmd", ["pretrain-kfold", "extract-features", "finetune"])
def test_cli_n_devices_refusals_come_before_any_spawn(cmd, tmp_path, capsys):
    extra = {"extract-features": ["--checkpoint", "none.pth"], "finetune": ["--checkpoint", "none.pth"]}.get(cmd, [])
    work = tmp_path / "w"
    argv = [cmd, "--data-path", str(tmp_path / "no_data"), "--work-dir", str(work), "--batch-size", "4", *extra]
    assert cli.run(argv + ["--n-devices", "2"]) == 2  # cuda by default, and no card here
    assert "2 NCCL ranks need 2 CUDA devices" in capsys.readouterr().err
    assert cli.run(argv + ["--n-devices", "3", "--device", "cpu"]) == 2
    assert "--batch-size 4 does not split into 3" in capsys.readouterr().err
    assert not work.exists()
