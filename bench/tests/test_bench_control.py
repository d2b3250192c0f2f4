"""The control of ``correct`` on the card, at each cell's own size: the
plain reference in the precision below the configuration's (TF32 for
ResNet18's float32, float8 for olmo-1b's bfloat16) put in the program's
place fails a limit that the program meets.  ``bench/calibrate.py`` reads
the same over many seeds."""
import time

import pytest
import torch

from bench import harness

CONTROLS = {"resnet18.search": "tf32", "olmo-1b.search": "fp8",
            "olmo-1b.sweep": "fp8", "resnet18.search.4chip": "tf32"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CONTROLS))
def test_control_fails_where_the_program_holds(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    chips = harness.Cell(bench, cell).chips
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA cards")
    res, _ = harness.run_cell(bench, cell, 2 ** 31 + 77, 8.0, False,
                              torch.device("cuda", 0), time.perf_counter(),
                              controls=(CONTROLS[cell],), log=lambda *a: None)
    limits = {k: v["limit"] for k, v in res["check"].items()}
    assert res["correct"] is True
    control = res["control"][CONTROLS[cell]]
    assert any(v > limits[k] for k, v in control.items())
