"""The training step on a mesh whose 'data' axis has more than one rank.

The JAX step (vit_ae_plus_plus_tpu/train/step.py) shards the batch over
'data' and so takes the gradient and the contrastive BatchNorm's statistics
over the global batch. The port's step reduces neither over a data group
yet, so it refuses such a mesh before any forward: no rank takes an update
of its own. A mesh of data = 1 (the sequence-parallel paths' (1, M)) and no
mesh at all train as before. The meshes here are built directly, with no
process group: the step must decide from the mesh's shape alone.
"""

import numpy as np
import pytest
import torch

from vit_ae_plus_plus_torch.configs import MAEConfig
from vit_ae_plus_plus_torch.models import build_model
from vit_ae_plus_plus_torch.parallel import Mesh, set_mesh
from vit_ae_plus_plus_torch.train import create_train_state, make_adamw, make_train_step

B, VOL, PATCH = 2, 16, 4
TINY = dict(volume_size=VOL, patch_size=PATCH, embed_dim=24, depth=1, num_heads=3,
            decoder_embed_dim=12, decoder_depth=1, decoder_num_heads=2,
            in_chans=1, contrastive=True, use_proj=False, dtype="float32")


def _mesh(data: int, model: int) -> Mesh:
    """Rank 0's place in a (data, model) grid, without process groups."""
    return Mesh(shape={"data": data, "model": model}, coords={"data": 0, "model": 0},
                ranks={"data": [m * model for m in range(data)], "model": list(range(model))},
                groups={"data": None, "model": None})


def _step_and_state():
    torch.manual_seed(0)
    model = build_model(MAEConfig(**TINY))
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


@pytest.mark.parametrize("data,model", [(2, 1), (2, 4), (4, 2)])
def test_step_refuses_a_data_axis_before_any_forward(data, model):
    step, state, calls, v1, v2 = _step_and_state()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    with set_mesh(_mesh(data, model)), pytest.raises(ValueError, match=r"data=\d.*DDP"):
        step(state, v1, v2, 0.01)
    assert calls == [] and state.step == 0
    after = state.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


@pytest.mark.parametrize("mesh", [None, (1, 1), (1, 4)], ids=["no_mesh", "mesh_1x1", "mesh_1x4"])
def test_step_trains_without_a_data_axis(mesh):
    step, state, calls, v1, v2 = _step_and_state()
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
    with set_mesh(_mesh(2, 1)), pytest.raises(ValueError):
        step(state, v1, v2, 0.01)
    state, _ = step(state, v1, v2, 0.01)
    step2, fresh, _, w1, w2 = _step_and_state()
    fresh, _ = step2(fresh, w1, w2, 0.01)
    got, want = state.model.state_dict(), fresh.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
