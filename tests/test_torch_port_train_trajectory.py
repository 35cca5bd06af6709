"""A 10-step f64 training trajectory of the port against the JAX package's
`make_train_step`, on the same numpy weights, batch statistics, volumes and
masking noise (injected through `forward_fn` on both sides), for the plain,
contrastive (with the unused projector) and 4-channel contrastive MAE.

Both sides run AdamW(0.9, 0.95) with the decay mask, the warmup-cosine
schedule per update and the per-epoch edge weight. Bounds are those of
tests/test_train_trajectory.py: loss 1e-7 relative at every step, worst
parameter leaf (BatchNorm statistics included) 1e-6 relative. In f64 the
rounding floor is ~1e-12, so any semantic difference (decay mask, schedule
count, betas, BatchNorm momentum or variance) shows far above them.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_mae import CASES, CONTR_W, PATCH, _data, _jax_forward, _jax_variables, _port, _rel
from vit_ae_plus_plus_tpu.train import make_adamw as jax_make_adamw
from vit_ae_plus_plus_tpu.train import make_train_step as jax_make_train_step
from vit_ae_plus_plus_tpu.train.optim import warmup_cosine_schedule as jax_schedule
from vit_ae_plus_plus_tpu.train.state import TrainState as JaxTrainState
from vit_ae_plus_plus_torch.train import (
    create_train_state,
    make_adamw,
    make_train_step,
    warmup_cosine_schedule,
)
from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax

STEPS, SPE, EPOCHS, WARMUP, LR, MIN_LR, WD = 10, 2, 5, 2, 1e-3, 1e-5, 0.05


def _edge_map_weight(step):
    return 0.01 * (1 - (step // SPE) / EPOCHS)


@pytest.fixture
def _float64_mode():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("case", list(CASES))
def test_training_trajectory_matches_jax(case, _float64_mode):
    contrastive, in_chans, _ = CASES[case]
    contr_w = CONTR_W if contrastive else 0.0
    v1, v2, noise = _data(case, steps=STEPS)
    jmodel, params, bs = _jax_variables(case, v1[0], v2[0], np.float64)

    tx = jax_make_adamw(jax_schedule(LR, MIN_LR, WARMUP, EPOCHS, SPE), weight_decay=WD)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=bs,
                           opt_state=tx.init(params), tx=tx)
    port = _port(case, params, bs, torch.float64)
    state = create_train_state(port, make_adamw(warmup_cosine_schedule(LR, MIN_LR, WARMUP, EPOCHS, SPE),
                                                weight_decay=WD))
    for i in range(STEPS):
        def jfwd(variables, a, b, _rng, n=noise[i]):
            return _jax_forward(jmodel, variables, a, b, n)

        jstep = jax_make_train_step(jmodel, PATCH, contr_weight=contr_w, loss_filters_dtype="float64",
                                    donate=False, forward_fn=jfwd)
        jstate, want = jstep(jstate, jnp.asarray(v1[i]), jnp.asarray(v2[i]), jax.random.PRNGKey(0),
                             jnp.float64(_edge_map_weight(i)))
        step = make_train_step(port, PATCH, contr_weight=contr_w, loss_filters_dtype="float64",
                               forward_fn=lambda m, a, b, _g, n=torch.from_numpy(noise[i]): m(a, b, noise=n))
        state, got = step(state, torch.from_numpy(v1[i]), torch.from_numpy(v2[i]), _edge_map_weight(i))
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-7 * abs(float(want["loss"])), i

    want_params = params_from_jax(jax.device_get(jstate.params), PATCH, in_chans,
                                  jax.device_get(jstate.batch_stats))
    sd = port.state_dict()
    assert set(want_params) == set(sd)
    worst = max((_rel(sd[k].numpy(), v.numpy()), k) for k, v in want_params.items())
    assert worst[0] < 1e-6, worst
