"""Driver kind `train`: the port's pretraining step, back to back.

Set-up builds one training state (the model of the configuration's preset
at the workload's dtype, `make_adamw` at `pretrain-kfold`'s learning rate
for the batch, `make_train_step` with the configuration's objective) on
weights drawn from the seed, and a pool of distinct batches of volumes and
masking noise, resident on the card. It drives that state through its
first three steps, reading what `correct` compares, warms up the traced
step's shapes with them, and hands the same state to the window, which
runs steps on the pool in turn until `--seconds` have passed and ends in a
device synchronisation. The masking noise reaches the model through the
step's `forward_fn` hook.

Traffic keys: batch, compute_dtype, ln_dtype, loss_filters_dtype,
attn_impl, pool_batches, profile_steps.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from benchmark.core import compare, inputs, trace
from benchmark.reference import mae as ref

CHECKED_STEPS = 3
WIDTHS = ("volume_size", "patch_size", "in_chans", "embed_dim", "depth", "num_heads", "decoder_embed_dim",
          "decoder_depth", "decoder_num_heads", "mlp_ratio", "contrastive")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def learning_rate(cfg: dict, batch: int) -> float:
    """`pretrain-kfold`'s absolute learning rate: blr x batch / 256."""
    return cfg["optimizer"]["blr"] * batch / 256


def build(ctx):
    """The program's training state, step and batch pool, and the readings
    of its first three steps."""
    from vit_ae_plus_plus_torch.models import MODEL_ZOO, build_model
    import vit_ae_plus_plus_torch.train.optim as optim
    import vit_ae_plus_plus_torch.train.state as state_mod
    import vit_ae_plus_plus_torch.train.step as step_mod

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    mae_cfg = MODEL_ZOO[cfg["preset"]](
        volume_size=cfg["volume_size"], patch_size=cfg["patch_size"], in_chans=cfg["in_chans"],
        dtype=tr["compute_dtype"], ln_dtype=tr["ln_dtype"], attn_impl=tr["attn_impl"])
    for k in WIDTHS:
        if getattr(mae_cfg, k) != cfg[k]:
            raise ValueError(f"preset {cfg['preset']} has {k}={getattr(mae_cfg, k)}, the configuration {cfg[k]}")
    with torch.device(dev):  # the weights made on the card; the fixed tables are made on the host
        model = build_model(mae_cfg).to(dev)
    spec = ref.mae_spec(cfg)
    named = dict(model.named_parameters())
    if set(named) != {n for n, _, _ in spec}:
        raise ValueError(f"the program's parameters differ from the configuration's: "
                         f"{sorted(set(named) ^ {n for n, _, _ in spec})}")
    with torch.no_grad():
        for n, t in inputs.make_params(spec, ctx.seed, dev).items():
            named[n].copy_(t)
    batch, opt = tr["batch"], cfg["optimizer"]
    tx = optim.make_adamw(learning_rate(cfg, batch), opt["weight_decay"], b1=opt["b1"], b2=opt["b2"])
    state = state_mod.create_train_state(model, tx, seed=inputs.stream_seed(ctx.seed, inputs.VIEWS))
    pool = inputs.make_train_batches(cfg, batch, tr["pool_batches"], ctx.seed, dev)
    current = {}

    def forward_fn(m, view1, view2, generator):
        return m(view1, view2, mask_ratio=cfg["mask_ratio"], noise=current["noise"])

    obj = cfg["objective"]
    step = step_mod.make_train_step(
        model, cfg["patch_size"], mask_ratio=cfg["mask_ratio"],
        contr_weight=obj["contr_weight"] if cfg["contrastive"] else 0.0,
        perceptual_weight=obj["perceptual_weight"], norm_pix_loss=obj["norm_pix_loss"],
        loss_filters_dtype=tr["loss_filters_dtype"], forward_fn=forward_fn)
    counter = {"i": 0}

    def run_step():
        b = pool[counter["i"] % len(pool)]
        counter["i"] += 1
        current["noise"] = b["noise"]
        return step(state, b["view1"], b.get("view2"), obj["edge_map_weight"])[1]

    losses, grad_norms = [], None
    for k in range(CHECKED_STEPS):
        losses.append(run_step()["loss"])
        if k == 0:  # the first gradient as the optimizer holds it: m_1 / (1 - b1)
            st = state.tx.opt.state
            grad_norms = ref.part_norms(
                (n, st[p]["exp_avg"] / (1 - opt["b1"]) if "exp_avg" in st.get(p, {}) else torch.zeros_like(p))
                for n, p in zip(state.tx.names, state.tx.params))
    start = inputs.make_params(spec, ctx.seed, dev)
    change = ref.part_norms((n, named[n].detach() - start[n]) for n in start)
    del start
    readings = {"losses": [float(v) for v in losses], "grad_norms": grad_norms, "change_norms": change}
    return {"state": state, "run_step": run_step, "readings": readings}


def reference_readings(ctx, precision: str = "f32") -> dict:
    """The reference's three steps from the same seed's weights and first
    three batches."""
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    params = inputs.make_params(ref.mae_spec(cfg), ctx.seed, dev)
    batches = inputs.make_train_batches(cfg, tr["batch"], CHECKED_STEPS, ctx.seed, dev)
    return ref.train_readings(cfg, params, batches, learning_rate(cfg, tr["batch"]), precision)


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run(ctx) -> dict:
    dev, tr = ctx.device, ctx.traffic
    prog = build(ctx)
    run_step = prog["run_step"]
    _sync(dev)
    setup_end = time.perf_counter()
    peak_setup = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    steps = 0
    while True:
        metrics = run_step()
        steps += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    _sync(dev)
    t1 = time.perf_counter()
    peak_window = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = 0 if math.isfinite(float(metrics["loss"])) else 1
    tr_trace = None
    if ctx.trace:
        k = tr["profile_steps"]
        tr_trace = trace.profile(lambda: [run_step() for _ in range(k)])
    readings = prog["readings"]
    del prog, run_step, metrics
    free(dev)
    ref_readings = reference_readings(ctx)
    numbers = compare.train_numbers(readings, ref_readings)
    return {
        "kind": "train", "setup_s": setup_end - ctx.t_start, "window_s": t1 - t0, "steps": steps,
        "batch": tr["batch"], "volumes": steps * tr["batch"], "attempted": steps, "failed": failed,
        "dtype": tr["compute_dtype"], "cfg": ctx.cfg, "trace": tr_trace,
        "profile_steps": tr.get("profile_steps"), "peak_window_bytes": peak_window,
        "memory_peak_bytes": max(peak_setup, peak_window), "numbers": numbers,
    }
