"""The trace reader and the per-layer metrics, on the CPU (the host's
outermost operations stand in for the device's), and the command's refusal
to run without a card."""
import subprocess
import sys
import time

import torch

from bench import harness
from bench.profile_reader import kernel_group
from bench.tests import tiny

torch.set_num_threads(2)


def test_kernel_groups():
    names = {
        "void (anonymous namespace)::quant_bitflip_kernel<0>(...)": "quant_bitflip",
        "void amax_kernel<float>(float const*, ...)": "quant_bitflip",
        "void (anonymous namespace)::bitflip_kernel<0, signed char>(...)": "bitflip",
        "void (anonymous namespace)::bfp::hash_kernel<0, signed char>(...)":
            "fault_weight_tiles",
        "(anonymous namespace)::bfp::product_kernel(CUtensorMap_st, ...)":
            "matmul_tiles",
        "void at::native::elementwise_kernel<128, 4, ...>": "elementwise",
        "Memcpy DtoD (Device -> Device)": "copies",
        "void cudnn::engines_precompiled::nchwToNhwcKernel<float>(...)": "layout",
        "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc": "cudnn_conv",
    }
    for name, group in names.items():
        assert kernel_group(name, "cudnn_conv") == group, name


def test_traced_run_reports_its_per_layer_metrics():
    res, _ = harness.run_cell(
        tiny.bench_json(), "resnet18.search", 9, 0.5, True,
        torch.device("cpu"), time.perf_counter(), conf=tiny.conf("resnet18"),
        traffic=tiny.traffic("search"), log=lambda *a: None)
    bench = tiny.bench_json()
    want = {m["name"] for m in bench["per_layer"]
            if "resnet18.search" in m["workloads"]}
    got = set(res["metrics"])
    # on the host no allocator peak is read, and the fault kernels' plain
    # versions run as PyTorch operations, under no kernel's name
    assert got == want - {"peak_mem_gb.cnn", "quant_bitflip_roofline.cnn"}
    assert all(m["unit"] for m in res["metrics"].values())
    d = res["device"]
    assert 0 < d["busy_s"] <= d["window_s"]
    for key in ("device_ops", "idle_gaps"):
        rows = res["breakdown"][key]
        assert 0 < len(rows) <= 10
        assert all(isinstance(n, str) and s > 0 for n, s in rows)
    assert 0 <= res["metrics"]["idle_share.cnn"]["value"] < 100
    assert res["metrics"]["reuse_share.cnn"]["value"] > 0


def test_every_metric_has_a_reader_and_its_cells_report_what_it_moves():
    bench = tiny.bench_json()
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"])), m["name"]
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]
    for cell in cells:
        reported = {n for n, ws in e2e.items() if cell in ws}
        assert "setup_s" in reported and len(reported) >= 2, cell
        assert any(cell in m["workloads"] for m in bench["per_layer"]), cell


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "resnet18.search",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr
