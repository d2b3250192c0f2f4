"""The work counts against hand-worked figures and against the
configuration's published shapes."""
import pytest

from bench import harness, peaks
from bench.tests import tiny


def test_resnet18_macs_an_image():
    conf = harness.load_json(harness.BENCH / "configs" / "resnet18.json")
    work = harness.work_module("resnet18").unit_work(conf)
    n = conf["n_eval"]
    macs = sum(w["flops"] for w in work) / 2 / n
    # He et al.'s widths at 32 x 32: 555 417 600 in the convolutions and a
    # 512 x 100 head (CIFAR-100)
    assert macs == 555_417_600 + 512 * 100 == 555_468_800
    # stem, one 64-wide block, the first stride-2 block with its projection
    assert [w["conv_flops"] / 2 / n for w in work[:4]] == [
        1_769_472, 75_497_472, 75_497_472,
        9 * 64 * 128 * 256 + 9 * 128 * 128 * 256 + 64 * 128 * 256]
    assert work[9]["conv_flops"] == 0 and work[9]["flops"] == 2 * 512 * 100 * n
    # the stem's input is the image: 32 x 32 x 3 float32, read and written
    assert work[0]["act_bytes"] == 2 * 4 * 32 * 32 * 3 * n
    assert work[0]["act_draws"] == 32 * 32 * 3 * n * 4
    ref = harness.reference_module("resnet18")
    assert sum(layer[0] for layer in ref.layers(conf)) == 555_468_800


def test_olmo_1b_block_work():
    conf = harness.load_json(harness.BENCH / "configs" / "olmo-1b.json")
    work = harness.work_module("olmo-1b").unit_work(conf)
    M, D, F, V, S, B = 8 * 256, 2048, 8192, 50304, 256, 8
    proj = 2 * M * (4 * D * D + 3 * D * F)
    assert proj == 274_877_906_944      # 2 x 2048 x 2^26
    attn = 2 * 2 * B * 16 * 128 * S * (S + 1) // 2
    assert work[0]["fm_flops"] == proj
    assert work[0]["flops"] == proj + attn
    assert work[15]["flops"] == proj + attn + 2 * M * D * V
    assert work[0]["fm_draws"] == (4 * D * D + 3 * D * F) * 6
    assert work[0]["act_bytes"] == 2 * 2 * M * D
    # 1.177 B parameters: the blocks and the tied embedding
    params = 16 * (4 * D * D + 3 * D * F) + V * D
    assert params == pytest.approx(1.177e9, rel=1e-3)


def test_peaks():
    assert peaks.INT32_OPS == pytest.approx(16.73e12, rel=1e-3)
    assert peaks.HASH_OPS_PER_DRAW == 15
    assert peaks.DTYPE_FLOPS == {"bfloat16": 989.4e12, "float32": 66.9e12}


def test_tiny_configs_stay_whole():
    for name in ("resnet18", "olmo-1b"):
        c = tiny.conf(name)
        assert c["check"]["limits"] == harness.load_json(
            harness.BENCH / "configs" / f"{name}.json")["check"]["limits"]
