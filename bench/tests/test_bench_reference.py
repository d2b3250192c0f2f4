"""The plain references against the port at the sizes of the repository's
CPU tests: the fault hash, quantization and masks bitwise, the cost
model exactly, and ΔAcc of the same rows under the same environment."""
import numpy as np
import pytest
import torch

from bench import harness
from bench.reference import cost, fault
from bench.tests import tiny

torch.set_num_threads(2)


def test_hash_and_threshold_bitwise():
    from repro_torch.kernels import faultmodel as fm
    idx = torch.randint(0, 2 ** 31 - 1, (4096,), dtype=torch.int64)
    for seed in (0, 7919 * 3 + 977 * 5 + 1, 2 ** 31 + 17, -5):
        for plane in (0, 3, 5):
            u = fault.draw24(idx, seed, plane)
            want = fm.uniform01(idx, seed, plane)
            assert torch.equal(u.to(torch.float32) * 2.0 ** -24, want)
    for r in (0.0, 1e-7, 0.07, 0.2, 0.35 * 0.2, 1.0, 2.0, float("nan")):
        assert fault.threshold(np.float32(r)) == int(fm.rate_threshold(
            np.float32(r)))


def test_masks_and_quantization_bitwise():
    from repro_torch.kernels import ref as kref
    from repro_torch.quant.fixedpoint import QuantSpec
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, 5, 7, generator=g)
    rates = np.array([0.2, 0.07, 0.0], np.float32)
    for bits, fb in ((8, 4), (8, 6), (16, 4)):
        masks = fault.flip_masks(x.numel(), 41, rates, fb, x.device)
        for d, r in enumerate(rates):
            got = fault.corrupt(x, bits, masks[d])
            want = kref.quant_bitflip_ref(x, 41, float(r), fb, QuantSpec(bits))
            assert torch.equal(got, want)
    w = torch.randn(6, 10, generator=g).to(torch.bfloat16)
    from repro_torch.models.layers import quantize_leaf
    q = quantize_leaf(w, 8)
    got = fault.corrupted_weights(w, 8, 977, rates, 6)
    want = kref.bitflip_ref(q.qw, 977, torch.as_tensor(rates), 6,
                            scale=q.scale, dtype=torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", ["resnet18", "olmo-1b", "olmo-1b-full"])
def test_latency_energy_exactly_the_port_s(name):
    from repro_torch.core.costmodel import (PAPER_DEVICES, POD_TIERS_4,
                                            CostModel)
    if name == "resnet18":
        conf = tiny.conf(name)
        from repro_torch.models.cnn import ResNet18
        layers = ResNet18.layer_infos(conf["num_classes"], conf["width"],
                                      conf["img"])
        devs = PAPER_DEVICES
    else:
        conf = tiny.conf("olmo-1b") if name == "olmo-1b" else \
            harness.load_json(harness.BENCH / "configs" / "olmo-1b.json")
        from bench.systems.lm import arch_config
        from repro_torch.models.graph import lm_layer_infos
        layers = lm_layer_infos(arch_config(conf), seq=4096)
        devs = POD_TIERS_4
    ref = harness.reference_module(conf["name"])
    P = np.random.default_rng(0).integers(0, len(devs), (64, len(layers)))
    cm = CostModel(layers, devs)
    lat, en = ref.latency_energy(conf, P)
    assert np.array_equal(lat, cm.latency(P))
    assert np.array_equal(en, cm.energy_of(P))
    assert np.array_equal(cost.fault_scales(conf["ladder"]),
                          np.array([d.fault_scale for d in devs], np.float32))


@pytest.mark.parametrize("name,dtype", [("resnet18", None),
                                        ("olmo-1b", "float32"),
                                        ("olmo-1b", "bfloat16")])
def test_delta_acc_against_the_port(name, dtype):
    conf = tiny.conf(name)
    if dtype:
        conf["dtype"] = dtype
    dev = torch.device("cpu")
    rngs = harness.seeds(11)
    ref_mod = harness.reference_module(name)
    made = ref_mod.make(conf, rngs["weights"], rngs["inputs"], dev)
    system = harness.load_module(
        harness.BENCH / "systems" / f"{conf['system']}.py",
        f"bench.systems.{conf['system']}").System(conf, made, dev, 1)
    scale = np.asarray(system.base_scale * np.float32(1.7), np.float32)
    system.set_env(scale)
    P = np.random.default_rng(1).integers(
        0, system.n_devices, (12, system.n_units))
    got = system.evaluator.delta_acc(P)
    ref = ref_mod.Reference(conf, made["params"], made.get("x", made.get(
        "tokens")))
    want = ref.delta_acc(P, scale)
    n = harness.n_items(conf)
    assert want.max() > 0                      # the faults move something
    assert np.abs(got - want).max() * n <= (0 if dtype != "bfloat16" else 1)


def test_cnn_system_refuses_a_fixed_point_the_port_does_not_run():
    conf = tiny.conf("resnet18")
    conf["fault"]["bits"] = 16
    system_mod = harness.load_module(
        harness.BENCH / "systems" / "cnn.py", "bench.systems.cnn")
    with pytest.raises(ValueError, match="8-bit fixed point with 4 faulty"):
        system_mod.System(conf, {}, torch.device("cpu"), 1)
