"""Whole runs at the tiny size on the CPU (the harness's look for a card
skipped): a sound program comes out correct; with the timed path broken
underneath, each fault a cell can have makes `correct` false; and each
cell's control (the reference one precision below the configuration's)
reads over the cell's limits. The training cells run in float32 here,
where the tiny program is exact, against the full cells' limits."""

import pytest

from benchmark.core import compare, faults, registry, runner
from benchmark.tests.tiny import tiny_root

TRAIN = ["vitae_b_96p8.train_bf16_b32", "mae_l_96p8.train_bf16_b32", "vitae_b_96p8.train_f32_b32"]
SEED = 2 ** 31 + 4321


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _run(root, name, dtype=None):
    ctx = runner.make_ctx(name, SEED, 0.3, False, "cpu", 0.0, root)
    if dtype:
        ctx.workload["traffic"]["compute_dtype"] = dtype
    run = registry.driver(ctx.workload["driver"], root).run(ctx)
    return runner.result(ctx, run, root)


@pytest.mark.parametrize("name", TRAIN)
def test_a_sound_training_run_is_correct(root, name):
    line = _run(root, name, "float32")
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "train_volumes_per_s"}


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", TRAIN)
def test_a_broken_training_step_is_not_correct(root, name, fault):
    with faults.plant(fault):
        line = _run(root, name, "float32")
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", TRAIN)
def test_the_training_control_reads_over_the_limits(root, name):
    ctx = runner.make_ctx(name, SEED, 0.3, False, "cpu", 0.0, root)
    drv = registry.driver("train", root)
    numbers = compare.train_numbers(drv.reference_readings(ctx, ctx.workload["control"]),
                                    drv.reference_readings(ctx))
    ok, checks = compare.judge(numbers, ctx.workload["limits"])
    assert not ok, checks


def test_the_entry_refuses_to_run_without_a_card(tmp_path):
    import subprocess
    import sys

    out = subprocess.run([sys.executable, str(registry.ROOT / "run.py"), "--workload", TRAIN[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == "", out.stdout + out.stderr
