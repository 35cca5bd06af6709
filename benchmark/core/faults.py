"""Faults planted in the program underneath a run, to show that the check of
`correct` catches them (the calibration runs and the tests; the
benchmark's own runs never plant one).

`state_unchanged`: the step computes and then leaves the parameters and
the optimizer's state as they were. `half_batch`: the loss over the first
half of the batch only, the mean taken over the rest.
"""

from __future__ import annotations

import contextlib
import copy

import torch

FAULTS = ("state_unchanged", "half_batch")


def _half_outputs(outputs: dict, view1: torch.Tensor):
    b = view1.shape[0]
    h = max(1, b // 2)
    out = dict(outputs)
    for k in ("pred", "mask", "ids_restore", "latent"):
        if k in out:
            out[k] = out[k][:h]
    for k in ("p1", "p2", "z1", "z2"):  # (volumes x tokens) rows
        if k in out:
            per = out[k].shape[0] // b
            out[k] = out[k][: h * per]
    return out, view1[:h]


@contextlib.contextmanager
def plant(name: str):
    """Within the block, the training step carries fault `name`."""
    import vit_ae_plus_plus_torch.train.step as step_mod

    if name == "half_batch":
        orig_terms = step_mod.mae_loss_terms

        def half_terms(outputs, view1, *a, **kw):
            out, v = _half_outputs(outputs, view1)
            return orig_terms(out, v, *a, **kw)

        step_mod.mae_loss_terms = half_terms
        try:
            yield
        finally:
            step_mod.mae_loss_terms = orig_terms
    elif name == "state_unchanged":
        orig_make = step_mod.make_train_step

        def make(*a, **kw):
            step = orig_make(*a, **kw)

            def unchanged(state, *args):
                params = [p.detach().clone() for p in state.tx.params]
                opt = copy.deepcopy(state.tx.opt.state_dict())
                count, n = state.tx.count, state.step
                state, metrics = step(state, *args)
                with torch.no_grad():
                    for p, q in zip(state.tx.params, params):
                        p.copy_(q)
                state.tx.opt.state.clear()
                if opt["state"]:
                    state.tx.opt.load_state_dict(opt)
                state.tx.count, state.step = count, n
                return state, metrics

            return unchanged

        step_mod.make_train_step = make
        try:
            yield
        finally:
            step_mod.make_train_step = orig_make
    else:
        raise ValueError(f"no training fault {name!r}")
