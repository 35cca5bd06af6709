"""The harness finds its parts by name, BENCHMARK.json agrees with them, and
nothing it runs imports JAX or the JAX package (the reference, nothing of
the port either)."""

import ast
import json
import shutil
from pathlib import Path

import pytest

from benchmark.core import registry, runner

BENCH = registry.ROOT
REPO = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex", "vit_ae_plus_plus_tpu"}


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    return sorted((BENCH / sub).rglob("*.py"))


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    files = _sources()
    assert len(files) > 20
    bad = {f"{f.relative_to(REPO)}: {r}" for f in files for r in _imported_roots(f) if r in FORBIDDEN}
    assert not bad, sorted(bad)


def test_the_reference_imports_nothing_of_the_port():
    files = _sources("reference")
    assert files
    bad = {f"{f.relative_to(REPO)}: {r}" for f in files for r in _imported_roots(f)
           if r in FORBIDDEN | {"vit_ae_plus_plus_torch"} or r == "benchmark"}
    assert not bad, sorted(bad)


def test_jax_check_compares_whole_top_level_names():
    assert runner.jax_modules(["vit_ae_plus_plus_torch.models", "jaxtyping", "numpy"]) == []
    assert runner.jax_modules(["jax.numpy", "flax", "vit_ae_plus_plus_tpu.models"]) == [
        "flax", "jax", "vit_ae_plus_plus_tpu"]


# what `reduced` may name: a cut of depth, never a width (BENCHMARK.json's contract)
CUTS = {"depth", "decoder_depth"}


@pytest.mark.parametrize("name", registry.workload_names())
def test_every_workload_names_a_configuration_a_driver_and_limits(name):
    wl = registry.workload(name)
    cfg = registry.config(wl["config"])
    assert registry.driver(wl["driver"]).run
    assert wl["chips"] in (1, 4)
    assert wl["limits"] and all(v > 0 for v in wl["limits"].values())
    assert set(cfg["reduced"]) <= CUTS & set(cfg)
    assert len(cfg["source"]) <= 200


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_agrees_with_the_files():
    bench = _bench()
    assert bench["paths"] == ["benchmark"]
    assert {w["name"] for w in bench["workloads"]} == set(registry.workload_names())
    assert {c["name"] for c in bench["configs"]} == {registry.workload(n)["config"] for n in registry.workload_names()}
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        wl = registry.workload(w["name"])
        assert (w["config"], w["chips"]) == (wl["config"], wl["chips"])
        assert w["traffic"] == w["name"].split(".", 1)[1]
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    readers = registry.metric_readers()
    for phase in ("end_to_end", "per_layer"):
        for m in bench[phase]:
            assert registry.NAME_RE.match(m["name"])
            assert (readers[m["name"]].PHASE, readers[m["name"]].UNIT) == (phase, m["unit"]), m["name"]
            assert set(m.get("workloads", cells)) <= cells
    assert all(m["moves"] in e2e for m in bench["per_layer"])


@pytest.mark.parametrize("name", registry.workload_names())
def test_readers_that_benchmark_json_does_not_declare_read_nothing_in_its_cells(name):
    """A reader under metrics/ that no entry of BENCHMARK.json declares
    returns None on a run of each declared cell's driver kind, so that no
    result line carries an undeclared metric."""
    from benchmark.core import trace

    declared = {m["name"] for k in ("end_to_end", "per_layer") for m in _bench()[k]}
    wl = registry.workload(name)
    run = {"kind": wl["driver"], "cfg": registry.config(wl["config"]), "batch": 1, "dtype": "float32",
           "steps": 1, "volumes": 1, "attempted": 1, "window_s": 1.0, "setup_s": 1.0, "profile_steps": 1,
           "peak_window_bytes": 1, "families": registry.kernel_families(),
           "trace": trace.Trace(start=0.0, end=1e6, device=[{"name": "k", "cat": "kernel", "ts": 0.0, "dur": 1.0}])}
    for n, reader in registry.metric_readers().items():
        if n not in declared:
            assert reader.read(run) is None, n


def test_a_workload_file_added_to_a_copy_is_found_with_no_code_edit(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    wl = registry.workload("vitae_b_96p8.train_bf16_b32")
    wl["name"] = "vitae_b_96p8.train_bf16_b16"
    wl["traffic"]["batch"] = 16
    (root / "workloads" / f"{wl['name']}.json").write_text(json.dumps(wl))
    assert wl["name"] in registry.workload_names(root)
    ctx = runner.make_ctx(wl["name"], 7, 1.0, False, "cpu", 0.0, root)
    assert ctx.traffic["batch"] == 16 and ctx.cfg["name"] == "vitae_b_96p8"
    assert registry.driver(ctx.workload["driver"], root).run


def test_kernel_families_own_the_ports_kernels():
    fams = registry.kernel_families()
    assert [n for n, _ in fams][0] == "attention"
    cases = {
        "void flash_fwd_wgmma_kernel<64, true>(Params)": "attention",
        "flash_bwd_dkdv_tf32_kernel": "attention",
        "flash_fwd_split_kernel": "attention",
        "vitae_lnd_tf32_kernel": "ln_dense",
        "vitae_ln_fwd_kernel": "layernorm",
        "nvjet_tst_192x192_64x3_1x2_h_bz_coopB_TNT": "gemm",
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": "gemm",
        "void at::native::elementwise_kernel<128, 4, at::native::direct_copy_kernel_cuda>": "copies",
        "Memcpy HtoD (Pinned -> Device)": "copies",
        "void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernelImpl>": "elementwise",
        "something_new_kernel": "other",
    }
    for name, fam in cases.items():
        assert registry.family_of(name, fams) == fam, name


def test_names_and_units_keep_to_the_allowed_characters():
    bench = _bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(registry.NAME_RE.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert 1 <= len(m["unit"]) <= 16 and all(c.isascii() and (c.isalnum() or c in "_/%.-") for c in m["unit"])
