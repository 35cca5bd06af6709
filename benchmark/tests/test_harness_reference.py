"""The plain reference agrees with the port's plain paths at the tiny
presets on the CPU, in float32: the training step's losses, first
gradients and parameter changes."""

import pytest
import torch

from benchmark.core import compare, registry, runner
from benchmark.reference import mae as ref
from benchmark.tests.tiny import tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _ctx(root, name, dtype):
    ctx = runner.make_ctx(name, 2 ** 31 + 77, 0.3, False, "cpu", 0.0, root)
    ctx.workload["traffic"].update(compute_dtype=dtype, attn_impl="plain")
    return ctx


@pytest.mark.parametrize("name", ["vitae_b_96p8.train_bf16_b32", "mae_l_96p8.train_bf16_b32"])
def test_reference_steps_agree_with_the_ports_f32_step(root, name):
    torch.manual_seed(0)
    ctx = _ctx(root, name, "float32")
    drv = registry.driver("train", root)
    prog = drv.build(ctx)["readings"]
    numbers = compare.train_numbers(prog, drv.reference_readings(ctx))
    assert numbers["loss_gap"]["value"] < 1e-5
    assert numbers["grad_norm_gap"]["value"] < 1e-5
    assert numbers["change_norm_gap"]["value"] < 1e-3


def test_the_key_bias_is_a_leaf_of_its_own_with_no_gradient(root):
    """Softmax ignores a bias on the keys: the reference's gradient of the
    key third of qkv.bias is round-off, so the change comparison leaves it
    out by its gradient alone."""
    ctx = _ctx(root, "vitae_b_96p8.train_bf16_b32", "float32")
    r = registry.driver("train", root).reference_readings(ctx)
    g = r["grad_norms"]
    med = sorted(g.values())[len(g) // 2]
    silent = {n for n, v in g.items() if v < compare.SILENT_GRAD * med}
    assert {n for n in g if n.endswith("qkv.bias[k]")} == silent


def test_precision_control_rounds_the_operands():
    x = torch.linspace(-3, 3, 1001)
    assert torch.equal(ref._round(x, "f32"), x)
    t = ref._round(x, "tf32")
    assert (t - x).abs().max() <= x.abs().max() * 2 ** -11 and not torch.equal(t, x)
    f = ref._round(x, "fp8")
    assert (f - x).abs().max() <= 3 * 2 ** -4 and len(torch.unique(f)) < 256
