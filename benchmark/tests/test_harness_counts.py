"""The yardstick's counts: the generalised FLOPs agree with the port's
`utils/flops.py` where both apply (but for the two backward passes that
file counts twice), count no more than the reference's products do, and
the attention roofline's least time is no more than what the algebraic
work needs, so no share can pass 100%."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.core import flops, inputs, registry
from benchmark.reference import mae as ref

TINY = dict(volume_size=16, patch_size=4, embed_dim=24, depth=2, num_heads=3, decoder_embed_dim=12,
            decoder_depth=1, decoder_num_heads=2)


def _tiny(name):
    return dict(registry.config(name), **TINY)


@pytest.mark.parametrize("batch, theirs_tflop, ours_tflop", [(8, 7.32, 7.29), (32, 29.27, 29.14)])
def test_step_flops_equal_the_ports_count_for_vitae_b(batch, theirs_tflop, ours_tflop):
    """The port's count (7.32 / 29.27 TFLOP) less the patch embed's and the
    prediction's Sobel backward, which it counts twice and the step does
    once (only one input of each needs a gradient)."""
    from vit_ae_plus_plus_torch.utils.flops import flagship_step_flops

    ours = flops.mae_step_flops(registry.config("vitae_b_96p8"), batch)
    theirs = flagship_step_flops(batch)
    assert ours["forward"] == pytest.approx(theirs["forward"], rel=1e-12)
    assert ours["total"] == pytest.approx(theirs["total"] - ours["embed"] - ours["sobel_pred"], rel=1e-12)
    assert (round(theirs["total"] / 1e12, 2), round(ours["total"] / 1e12, 2)) == (theirs_tflop, ours_tflop)


def test_mae_l_counts_one_view_and_a_deeper_wider_encoder():
    b, l = (flops.mae_step_flops(registry.config(n), 32) for n in ("vitae_b_96p8", "mae_l_96p8"))
    assert l["encoder"] == pytest.approx(b["encoder"] / 2 * (24 / 12) * (
        flops.block_flops(433, 1024, 4.0) / flops.block_flops(433, 768, 4.0)))
    assert l["decoder"] == b["decoder"]
    assert round(l["total"] / 1e12, 2) == 40.33


@pytest.mark.parametrize("name", ["vitae_b_96p8", "mae_l_96p8"])
def test_step_count_is_no_more_than_the_references_products(name):
    cfg = _tiny(name)
    P = inputs.make_params(ref.mae_spec(cfg), 3, "cpu")
    for p in P.values():
        p.requires_grad_(True)
    b = inputs.make_train_batches(cfg, 2, 1, 3, "cpu")[0]
    with FlopCounterMode(display=False) as fc:
        out = ref.mae_forward(P, cfg, b["view1"], b.get("view2"), b["noise"])
        ref.mae_loss(out, b["view1"], cfg, cfg["objective"]).backward()
    assert flops.mae_step_flops(cfg, 2)["total"] <= fc.get_total_flops()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["vitae_b_96p8", "mae_l_96p8"])
def test_attention_least_time_is_no_more_than_its_algebraic_work_needs(dtype, name):
    cfg = registry.config(name)
    calls = flops.attention_calls(cfg, 32)
    least = flops.attention_least_seconds(calls, dtype, backward=True)
    ops = sum(layers * 4 * b * h * n * n * d for b, h, n, d, layers in calls) * 3
    moved = sum(layers * 4 * b * n * h * d for b, h, n, d, layers in calls) * 3
    moved *= flops.ELEMENT_BYTES[dtype]
    # every call is bound by one of the two; each bound is the algebraic work
    assert least <= ops / flops.PEAK_FLOPS[dtype] + moved / flops.HBM_BYTES_PER_S
    assert least >= max(ops / flops.PEAK_FLOPS[dtype], moved / flops.HBM_BYTES_PER_S) * (1 - 1e-12)
    # the attention is part of the step's count
    assert 3 * sum(layers * 4 * b * h * n * n * d for b, h, n, d, layers in calls) <= flops.mae_step_flops(cfg, 32)["total"]


def _event(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_a_trace_is_read_between_its_device_markers():
    from benchmark.core import trace

    events = [_event("spin_kernel", 100, 1), _event("flash_fwd_wgmma_kernel", 90, 20),
              _event("flash_fwd_wgmma_kernel", 130, 10), _event("nvjet_gemm", 150, 30),
              _event("flash_fwd_wgmma_kernel", 200, 10), _event("spin_kernel", 220, 1),
              _event("cudaLaunchKernel", 180, 5, "cuda_runtime"), _event("flash_late", 400, 5)]
    tr = trace.parse(events)
    assert (tr.start, tr.end) == (100, 221)
    assert [e["name"] for e in tr.kernels()][0] == "flash_fwd_wgmma_kernel"  # the one running at the start
    assert tr.busy_s() == pytest.approx((10 + 10 + 30 + 10) / 1e6)
    gaps = tr.idle_gaps()
    assert max(b - a for a, b in gaps) == 20 and tr.host_at(182) == "cudaLaunchKernel"


def test_readers_of_the_traced_run_return_nothing_without_a_trace():
    """An untraced run, and a traced one with no device event: the
    per-layer readers that read the trace find nothing and return None,
    never 0."""
    from benchmark.core import trace

    cfg = registry.config("vitae_b_96p8")
    base = {"kind": "train", "cfg": cfg, "batch": 32, "dtype": "bfloat16", "steps": 10, "volumes": 320,
            "window_s": 1.0, "setup_s": 1.0, "profile_steps": 3, "peak_window_bytes": 0,
            "families": registry.kernel_families()}
    readers = registry.metric_readers()
    for tr in (None, trace.Trace(start=0.0, end=1e6)):
        run = dict(base, trace=tr)
        for name in ("attn_roofline_pct.train", "device_idle_pct.train", "train_launches_per_step",
                     "peak_mem_gib.train"):
            assert readers[name].read(run) is None, name
