"""Quickstart: fault-resilient partitioning of ResNet18 across an
Eyeriss-class and a SIMBA-class accelerator (the paper's core loop), the
counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.quickstart [--steps N]
        [--generations G] [--n-eval B] [--device cuda]

Trains (or loads) ResNet18 on the synthetic dataset, runs AFarePart's
NSGA-II with true fault-injected ΔAcc in the loop (the staged engine
under the kernel backend), prints the Pareto front and compares the
chosen deployment with the fault-unaware baseline under 20 % LSB faults.
"""
from __future__ import annotations

import argparse

from repro_torch import cnn_setup
from repro_torch._device import resolve_device
from repro_torch.core import (PAPER_DEVICES, AFarePart, FaultSpec,
                              FaultUnawareBaseline, NSGA2Config,
                              device_memory_budget)
from repro_torch.models.cnn import ResNet18


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300,
                    help="training steps (cached per step count)")
    ap.add_argument("--generations", type=int, default=15)
    ap.add_argument("--n-eval", type=int, default=512,
                    help="calibration images per ΔAcc evaluation")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name, width = "resnet18", cnn_setup.WIDTH

    print("== training/loading ResNet18 on the synthetic dataset ==")
    params = cnn_setup.get_trained(name, steps=args.steps, device=dev)
    clean = cnn_setup.clean_accuracy(name, params, args.n_eval, device=dev)
    print(f"clean (quantization-free) top-1: {clean:.3f}")

    spec = FaultSpec(weight_fault_rate=0.2, act_fault_rate=0.2,
                     faulty_bits=4, bits=16)
    layers = ResNet18.layer_infos(num_classes=cnn_setup.NUM_CLASSES,
                                  width=width, img=cnn_setup.IMG)
    cfg = NSGA2Config(population=24, generations=args.generations, seed=0)

    # the store holds a quarter of the free memory: at width 0.5 one
    # chain of stored prefixes is ~300 MiB, and the reference's 256 MiB
    # default would evict and recompute most of them
    store = device_memory_budget(device=dev) // 4
    print("\n== AFarePart offline phase (fault injection in the loop) ==")
    print(f"staged ΔAcc engine, activation store of {store / 2**30:.1f} GiB")
    ev = cnn_setup.make_evaluator(name, params, spec, n_eval=args.n_eval,
                                  max_store_bytes=store, device=dev)
    plan = AFarePart(layers, PAPER_DEVICES, acc_evaluator=ev,
                     nsga2_config=cfg).optimize()
    print(f"Pareto front: {plan.front.shape[0]} partitions")
    for i in range(min(5, plan.front.shape[0])):
        lat, en, da = plan.front_objs[i]
        print(f"  P{i}: lat={lat * 1e3:.2f}ms energy={en * 1e3:.2f}mJ "
              f"dAcc={da:.3f}  map={''.join(map(str, plan.front[i]))}")
    print(f"deployed P*: {''.join(map(str, plan.partition))} "
          f"(0=eyeriss fault-prone, 1=simba reliable)")

    base = FaultUnawareBaseline(layers, PAPER_DEVICES,
                                nsga2_config=cfg).optimize()
    print("\n== evaluation under 20% LSB faults (weights+activations) ==")
    acc = {}
    for tool, p in (("AFarePart", plan), ("fault-unaware", base)):
        acc[tool] = cnn_setup.accuracy_under_partition(
            name, params, p.partition, 0.2, 0.2, n_eval=args.n_eval,
            device=dev)
        print(f"  {tool:14s} top-1={acc[tool]:.3f} "
              f"lat={p.latency * 1e3:.2f}ms energy={p.energy * 1e3:.2f}mJ")
    return {"plan": plan, "baseline": base, "clean": clean,
            "accuracy": acc, "evaluator": ev}


if __name__ == "__main__":
    main()
