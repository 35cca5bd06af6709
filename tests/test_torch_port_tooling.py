"""The port's tooling against the JAX package, on the CPU: checkpoint URLs,
the `_fast` presets' note, the TensorBoard images and projector, the
reference's stock filters, the profile attribution, `doctor`, the analytic
FLOPs and the CLI's subcommands.

Tolerances: the filters within 1e-5 relative in f32 (the same f32
arithmetic in another summation order; measured under 4e-7); everything
else is held bitwise or exactly."""

import functools
import http.server
import json
import os
import struct
import threading
import zipfile
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vit_ae_plus_plus_tpu.ops import filters as jax_filters
from vit_ae_plus_plus_tpu.train.checkpoint import resolve_checkpoint_path as jax_resolve
from vit_ae_plus_plus_tpu.utils import flops as jax_flops
from vit_ae_plus_plus_tpu.utils import profile_tools as jax_profile
from vit_ae_plus_plus_tpu.utils import tb_events as jax_tb
from vit_ae_plus_plus_torch import cli
from vit_ae_plus_plus_torch.ops import filters
from vit_ae_plus_plus_torch.train.checkpoint import resolve_checkpoint_path
from vit_ae_plus_plus_torch.utils import doctor, flops, profile_tools, tb_events


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def served(tmp_path):
    """A directory served over HTTP on 127.0.0.1 -> (base URL, directory)."""
    root = tmp_path / "served"
    root.mkdir()
    handler = functools.partial(http.server.SimpleHTTPRequestHandler, directory=str(root))
    handler.log_message = lambda *a: None
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", root
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("scheme", ["file", "http"])
def test_resolve_checkpoint_path_caches_a_url_as_jax_does(tmp_path, served, scheme):
    base, root = served
    payload = np.random.default_rng(0).bytes(4096)
    (root / "fold_0").mkdir()
    src = root / "fold_0" / "checkpoint-min_loss.pth"
    src.write_bytes(payload)
    url = f"{base}/fold_0/checkpoint-min_loss.pth" if scheme == "http" else src.as_uri()
    got = resolve_checkpoint_path(url, cache_dir=str(tmp_path / "port"))
    want = jax_resolve(url, cache_dir=str(tmp_path / "jax"))
    assert os.path.basename(got) == os.path.basename(want)
    assert os.path.basename(got).endswith("_checkpoint-min_loss.pth")
    assert Path(got).read_bytes() == Path(want).read_bytes() == payload
    assert not list((tmp_path / "port").glob("*.part"))
    src.write_bytes(b"changed")  # a cached URL is not fetched again
    assert resolve_checkpoint_path(url, cache_dir=str(tmp_path / "port")) == got
    assert Path(got).read_bytes() == payload
    local = str(tmp_path / "local.pth")
    assert resolve_checkpoint_path(local) == local == jax_resolve(local)


def test_cli_resolves_a_url_once_before_the_ranks_are_spawned(tmp_path, monkeypatch):
    """A multi-rank command resolves `--checkpoint` in the parent, and the
    ranks' argv names the cached file, so no two ranks fetch one URL."""
    from vit_ae_plus_plus_torch.train import checkpoint as ck

    src = tmp_path / "mae.pth"
    src.write_bytes(b"weights")
    calls, spawned = [], []
    real = ck.resolve_checkpoint_path
    monkeypatch.setattr(ck, "resolve_checkpoint_path",
                        lambda p: calls.append(p) or real(p, cache_dir=str(tmp_path / "cache")))
    monkeypatch.setattr(cli, "launch_ranks", lambda args, argv, n, **kw: spawned.append((args, argv)) or "done")
    argv = ["extract-features", "--checkpoint", src.as_uri(), "--work-dir", str(tmp_path / "w"), "--n-devices", "2",
            "--device", "cpu"]
    assert cli.main(argv) == 0
    (args, rank_argv), = spawned
    local = rank_argv[rank_argv.index("--checkpoint") + 1]
    assert calls == [src.as_uri()] and args.checkpoint == local and Path(local).read_bytes() == b"weights"
    assert rank_argv[:1] + rank_argv[3:] == argv[:1] + argv[3:]


def test_serve_and_compile_engine_label_the_fast_presets_as_non_parity(tmp_path, monkeypatch, capsys):
    """JAX tests/test_cli_and_config.py::test_serve_labels_fast_presets_as_non_parity,
    with compile-engine beside serve and the artifact's preset read from
    its meta.json's config."""
    import vit_ae_plus_plus_torch.serving as serving
    import vit_ae_plus_plus_torch.serving_aot as serving_aot

    monkeypatch.setattr(serving, "serve", lambda *a, **kw: None)
    monkeypatch.setattr(serving, "build_engine", lambda *a, **kw: None)
    monkeypatch.setattr(serving_aot, "save_engine", lambda engine, path: {
        "kind": "features", "batch_size": 8, "volume_shape": [1, 96, 96, 96], "quantize": "none",
        "fingerprint": {"platform": "cpu", "device_name": "x"}})
    monkeypatch.setattr(cli.os.path, "getsize", lambda p: 0)
    for cmd in (["serve"], ["compile-engine", "--out", str(tmp_path / "e.vitae")]):
        assert cli.main(cmd + ["--checkpoint", "dummy", "--model", "contr_mae_vit_base_patch16_fast"]) == 0
        assert "non-parity preset" in capsys.readouterr().err
        assert cli.main(cmd + ["--checkpoint", "dummy", "--model", "contr_mae_vit_base_patch16"]) == 0
        assert "non-parity" not in capsys.readouterr().err
    for name, labelled in (("contr_mae_vit_base_patch16_fastdec", True), ("contr_mae_vit_base_patch16", False)):
        eng = tmp_path / f"{name}.vitae"
        with zipfile.ZipFile(eng, "w") as zf:
            zf.writestr("meta.json", json.dumps({"format_version": 1, "config": {"model_name": name}}))
        assert cli.main(["serve", "--engine", str(eng)]) == 0
        assert ("non-parity preset" in capsys.readouterr().err) == labelled


def test_png_grid_and_image_event_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    for img in (rng.integers(0, 256, (7, 5), dtype=np.uint8), rng.integers(0, 256, (4, 6, 3), dtype=np.uint8),
                rng.integers(0, 256, (3, 3, 1), dtype=np.uint8)):
        assert tb_events.encode_png(img) == jax_tb.encode_png(img)
    with pytest.raises(ValueError, match="1 or 3 channels"):
        tb_events.encode_png(np.zeros((2, 2, 2), np.uint8))
    imgs = rng.standard_normal((11, 3, 5, 4)).astype(np.float32)
    grid = tb_events.image_grid(imgs, ncol=4, pad=1)
    np.testing.assert_array_equal(grid, jax_tb.image_grid(imgs, ncol=4, pad=1))
    records = []
    for mod, name in ((tb_events, "port"), (jax_tb, "jax")):
        w = mod.EventWriter(str(tmp_path / name))
        w.image("grid", grid, 3)
        w.image("raw", imgs[0, 0], 4)
        w.close()
        records.append([_strip_wall_time(r) for r in _records(w.path)][1:])
    assert records[0] == records[1] and len(records[0]) == 2


def test_write_projector_files_equal_jax(tmp_path):
    feats = np.random.default_rng(1).standard_normal((6, 5)).astype(np.float32)
    for mod, name in ((tb_events, "port"), (jax_tb, "jax")):
        for tag, labels in (("ssl_embedding", [0, 1, 1, 0, 1, 0]), ("other", None), ("ssl_embedding", [1] * 6)):
            mod.write_projector(str(tmp_path / name), feats, labels, tag=tag)
    got, want = sorted(os.listdir(tmp_path / "port")), sorted(os.listdir(tmp_path / "jax"))
    assert got == want and "projector_config.pbtxt" in got
    for f in got:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def _records(path):
    """The TFRecord payloads of an events file."""
    data, out, i = Path(path).read_bytes(), [], 0
    while i < len(data):
        (n,) = struct.unpack("<Q", data[i:i + 8])
        out.append(data[i + 12:i + 12 + n])
        i += 16 + n
    return out


def _strip_wall_time(event: bytes) -> bytes:
    assert event[0] == 0x09  # field 1, a double: the wall time
    return event[9:]


@pytest.mark.parametrize("name", ["sobel_edges_3d_conv", "gaussian_blur_3d_conv", "gaussian_blur_3d_dense"])
def test_stock_filters_match_jax(name):
    v = np.random.default_rng(2).standard_normal((2, 2, 12, 10, 14)).astype(np.float32)
    got = getattr(filters, name)(torch.from_numpy(v)).numpy()
    want = np.asarray(getattr(jax_filters, name)(jnp.asarray(v)))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # the dense and conv paths against the port's separable ones: summation order only
    banded = (filters.sobel_edges_3d if name.startswith("sobel") else filters.gaussian_blur_3d)(torch.from_numpy(v))
    np.testing.assert_allclose(got, banded.numpy(), rtol=1e-5, atol=1e-5 * np.abs(want).max())


OPS = {  # the names the port's traces show, with (ms, count)
    "void flash_fwd_wgmma_kernel<64, false>(CUtensorMap, CUtensorMap, CUtensorMap, FlashParams)": (3.1, 36),
    "void flash_bwd_delta_kernel<__nv_bfloat16, 64>(FlashBwdParams)": (0.4, 36),
    "void vitae_lnd_tf32_kernel<128>(LndParams)": (2.0, 12),
    "void vitae_ln_fwd_kernel<float>(LnParams)": (0.2, 2),
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float>(int, float, float const*)": (
        0.9, 30),
    "Memcpy HtoD (Pageable -> Device)": (1.5, 3),
    "Memset (Device)": (0.1, 9),
    "void at::native::elementwise_kernel<128, 4, direct_copy_kernel_cuda>(int, Array<char*, 2>)": (0.7, 40),
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": (5.0, 120),
    "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN": (4.0, 90),
    "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_16x6_tn_align4>(Params)": (1.0, 6),
    "void cudnn::engines_precompiled::nchwToNhwcKernel<float>(cudnn::engines_precompiled::nchw2nhwc_params_t<float>)":
        (0.3, 2),
    "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nchw": (0.8, 4),
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)": (0.6, 1),
    "void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernelImpl>(int, Array<char*, 2>)": (
        2.2, 24),
}


# names that both packages' rules put in the same bucket
SHARED_OPS = {"flash_fwd_kernel": (3.1, 36), "flash_bwd_dq_kernel": (2.4, 36), "direct_copy_kernel": (0.7, 40),
              "transpose_kernel": (0.3, 4), "convolution_fwd": (0.8, 4), "gemm_bf16_tn": (5.0, 120),
              "add_kernel": (0.25, 12), "gelu_kernel": (2.2, 24)}


def test_attribute_and_format_table_equal_jax():
    got = profile_tools.attribute(SHARED_OPS, steps=3)
    want = jax_profile.attribute(SHARED_OPS, steps=3)
    assert got == want and list(got) == list(want)
    assert profile_tools.format_table(got) == jax_profile.format_table(want)
    assert profile_tools.format_table(got, show_ops=1) == jax_profile.format_table(want, show_ops=1)
    table = profile_tools.attribute(OPS, steps=3)
    assert list(table) == sorted(table, key=lambda b: (b == "__total__", -table[b]["ms_per_step"]))
    assert abs(table["__total__"]["ms_per_step"] - sum(ms for ms, _ in OPS.values()) / 3) < 1e-12
    bucket = {name: profile_tools.bucket_of(name) for name in OPS}
    assert {n for n, b in bucket.items() if b == "attention kernels"} == {n for n in OPS if "flash_" in n}
    assert bucket["void vitae_lnd_tf32_kernel<128>(LndParams)"] == "matmul fusions"
    assert bucket["void vitae_ln_fwd_kernel<float>(LnParams)"] == "LN reductions"
    assert {b for n, b in bucket.items() if "layer_norm" in n} == {"LN reductions"}
    assert {bucket[n] for n in OPS if n.startswith("Mem") or "copy" in n} == {"copies/layout"}
    assert {bucket[n] for n in OPS if "cudnn" in n or "fprop" in n} == {"convolutions"}
    assert {bucket[n] for n in OPS if n.startswith(("sm90_xmma_gemm", "nvjet")) or "cutlass" in n} == {"matmul fusions"}
    assert {bucket[n] for n in OPS if n.startswith("nccl")} == {"collectives"}
    assert {bucket[n] for n in OPS if "Gelu" in n} == {"misc"}


def test_profile_attrib_reads_a_cpu_trace(tmp_path, capsys):
    """A real torch.profiler trace on the CPU (no device events: its cpu_op
    events) round-trips through the CLI to a non-empty table, the newest
    trace of the directory taken."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(64, 64)
    for name in ("fold_0_epoch_1.json", "fold_1_epoch_1.json"):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                torch.nn.functional.layer_norm(x @ x, (64,)).sum()
        prof.export_chrome_trace(str(tmp_path / name))
    os.utime(tmp_path / "fold_0_epoch_1.json", (1, 1))
    assert profile_tools.find_trace_files(str(tmp_path)) == [str(tmp_path / "fold_1_epoch_1.json")]
    ops = profile_tools.parse_trace(str(tmp_path / "fold_1_epoch_1.json"))
    assert ops["aten::mm"][1] == 3 and ops["aten::layer_norm"][1] == 3
    assert cli.main(["profile-attrib", "--trace-dir", str(tmp_path), "--steps", "3", "--json"]) == 0
    table = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert table["__total__"]["ms_per_step"] > 0 and table["LN reductions"]["ms_per_step"] > 0
    assert abs(sum(r["ms_per_step"] for b, r in table.items() if b != "__total__")
               - table["__total__"]["ms_per_step"]) < 1e-9
    assert cli.main(["profile-attrib", "--trace-dir", str(tmp_path)]) == 0
    assert "TOTAL (device busy)" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        profile_tools.find_trace_files(str(tmp_path / "none"))


def _doctor_lines(capsys, *args):
    rc = cli.main(["doctor", *args])
    return rc, capsys.readouterr().out.strip().splitlines()


def test_doctor_passes_on_the_cpu_and_fails_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, lines = _doctor_lines(capsys, "--device", "cpu")
    assert rc == 0, lines
    assert lines[-1] == "doctor: all checks passed"
    names = [line.split("] ", 1)[1].split(":", 1)[0] for line in lines[:-1]]
    assert names == [name for name, _ in doctor.CHECKS]
    assert all(line.startswith(("[  ok]", "[warn]")) for line in lines[:-1])
    assert "[  ok] native host libraries: built and loaded: augment3d, libsvm, liblinear, sag, tree" in lines
    rc, lines = _doctor_lines(capsys)
    assert rc == 1
    failed = {line.split("] ", 1)[1].split(":", 1)[0] for line in lines if line.startswith("[FAIL]")}
    assert {"cuda device", "kernel libraries"} <= failed
    assert lines[-1] == f"doctor: {len(failed)} check(s) FAILED"


def test_doctor_counts_a_crashing_check_as_failed(capsys):
    """JAX tests' test_doctor_reports_failures: a check that raises fails."""
    def boom(device):
        raise RuntimeError("kaput")

    rc = doctor.run_doctor([("fine", lambda d: ("ok", "x")), ("boom", boom)], device="cpu")
    out = capsys.readouterr().out
    assert rc == 1 and "[FAIL] boom: check crashed: RuntimeError: kaput" in out and "1 check(s) FAILED" in out
    assert doctor.run_doctor([("fine", lambda d: ("ok", "x")), ("meh", lambda d: ("warn", "y"))], device="cpu") == 0


def test_doctor_flags_stale_engine_artifacts_and_build_entries(tmp_path, monkeypatch):
    from vit_ae_plus_plus_torch.kernels import _build
    from vit_ae_plus_plus_torch.serving_aot import FORMAT, FORMAT_VERSION, fingerprint

    monkeypatch.chdir(tmp_path)
    assert doctor._check_engines("cpu") == ("ok", "no .vitae artifacts under the working directory")
    here = fingerprint("cpu")
    metas = {"good.vitae": {"format": FORMAT, "format_version": FORMAT_VERSION, "fingerprint": here, "kernels": {}},
             "old.vitae": {"format": FORMAT, "format_version": 0, "fingerprint": here},
             "elsewhere.vitae": {"format": FORMAT, "format_version": FORMAT_VERSION,
                                 "fingerprint": {**here, "torch": "1.0"}},
             "sources.vitae": {"format": FORMAT, "format_version": FORMAT_VERSION, "fingerprint": here,
                               "kernels": {"flash_fwd": {"sources": "0" * 64}}}}
    for name, meta in metas.items():
        with zipfile.ZipFile(tmp_path / name, "w") as zf:
            zf.writestr("meta.json", json.dumps(meta))
    status, detail = doctor._check_engines("cpu")
    assert status == "warn" and "rebuild with compile-engine" in detail and "good.vitae" not in detail
    for name in ("old.vitae", "elsewhere.vitae: torch", "sources.vitae: kernel sources of flash_fwd"):
        assert name in detail
    build = tmp_path / "build"
    build.mkdir()
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    (build / "libflash_fwd-0123456789abcdef.so").write_bytes(b"")
    status, detail = doctor._check_build_dir("cpu")
    assert status == "warn" and "1 built from sources this checkout no longer has" in detail


@pytest.mark.parametrize("batch", [1, 4, 8])
def test_flagship_step_flops_equal_jax(batch):
    assert flops.flagship_step_flops(batch) == jax_flops.flagship_step_flops(batch)
    assert flops.flagship_step_flops(batch, volume=64, patch=16, in_chans=4) == jax_flops.flagship_step_flops(
        batch, volume=64, patch=16, in_chans=4)
    assert flops.H100_SXM_BF16_PEAK_FLOPS == 989e12


def test_every_jax_subcommand_is_in_the_port(capsys):
    from vit_ae_plus_plus_tpu.cli import main as jax_main

    with pytest.raises(SystemExit):
        jax_main(["--help"])
    usage = capsys.readouterr().out.split("{", 1)[1].split("}", 1)[0]
    jax_cmds = set(usage.split(","))
    port_cmds = set(cli.build_parser()._subparsers._group_actions[0].choices)
    assert {"sanity-viz", "explore-data", "profile-attrib", "export-torch", "doctor"} <= jax_cmds
    assert jax_cmds <= port_cmds, sorted(jax_cmds - port_cmds)
