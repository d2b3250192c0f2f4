"""Online phase (paper Alg. 1 lines 13-19): serve a small LM with batched
requests while a device tier starts glitching mid-flight; the engine's
canary evaluation crosses θ, NSGA-II runs again with the live scales and
the deployment hot-swaps to a more resilient partition.  The counterpart
of ``examples/serve_fault_resilient.py``, with its model, settings and
printout.

    PYTHONPATH=src python -m repro_torch.serve_fault_resilient [--device cuda]

On a machine without a card add ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import (POD_TIERS, AFarePart, CostModel,
                              FaultEnvironment, NSGA2Config,
                              OnlineReconfigurator,
                              SurrogateAccuracyEvaluator)
from repro_torch.models.graph import lm_layer_infos
from repro_torch.models.transformer import init_lm
from repro_torch.serve import Engine, Request, ServeConfig

__all__ = ["main"]


def main(argv=None) -> dict:
    """Runs the demo and returns ``{"plan", "theta", "events",
    "swap_events", "requests"}``: the deployed plan, θ, the
    reconfigurator's events, the engine's swaps and the served requests."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # 8 layers so the layer->tier mapping has room to express policy
    cfg = dataclasses.replace(get_config("olmo-1b").reduced(), n_layers=8)
    params = init_lm(cfg, seed=0, device=dev)
    layers = lm_layer_infos(cfg, seq=64)
    cm = CostModel(layers, POD_TIERS)
    ev = SurrogateAccuracyEvaluator(cm)

    print("== offline phase: NSGA-II over layer->tier mappings ==")
    part = AFarePart(layers, POD_TIERS, acc_evaluator=ev,
                     nsga2_config=NSGA2Config(population=20, generations=10,
                                              seed=0))
    plan = part.optimize()
    print(f"deployed P*: {''.join(map(str, plan.partition))} "
          f"(0=low-volt tier, 1=reliable tier)")

    def observe(partition, scales):
        old = cm.fault_scale.copy()
        cm.fault_scale = np.asarray(scales, float)
        v = float(cm.sensitivity_surrogate(partition[None, :])[0])
        cm.fault_scale = old
        return v

    env = FaultEnvironment(base_scale=np.array([1.0, 0.1]),
                           schedule={12: np.array([1.0, 30.0])})
    theta = observe(plan.partition, env.base_scale) * 2 + 1e-9
    rec = OnlineReconfigurator(part, plan, theta=theta, observe_fn=observe,
                               reopt_generations=5)

    def partition_to_rates(partition, scales):
        sc = np.asarray(scales if scales is not None else env.base_scale)
        r = 0.2 * sc[partition]
        return r.astype(np.float32), r.astype(np.float32)

    print("\n== online phase: serving with canary monitoring ==")
    eng = Engine(cfg, params, ServeConfig(canary_every=4), fault_env=env,
                 reconfigurator=rec, partition_to_rates=partition_to_rates)
    rng = np.random.default_rng(1)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, 6).astype(
        np.int32), max_new_tokens=24) for i in range(4)]
    eng.generate(reqs)
    print(f"served {len(reqs)} requests x 24 tokens")
    print(f"reconfig events: {len(rec.events)} (engine swaps at decode "
          f"steps {eng.swap_events})")
    for e in rec.events:
        print(f"  step {e.step}: observed dAcc={e.observed_delta_acc:.4f} "
              f"> theta={theta:.4f}")
        print(f"    old map {''.join(map(str, e.old_partition))}")
        print(f"    new map {''.join(map(str, e.new_partition))} "
              f"(predicted dAcc={e.new_predicted_delta_acc:.4f})")
    if not rec.events:
        raise RuntimeError("expected at least one reconfiguration")
    print("\nOK: tier glitch detected, repartitioned, serving continued.")
    return {"plan": plan, "theta": theta, "events": rec.events,
            "swap_events": eng.swap_events, "requests": reqs}


if __name__ == "__main__":
    main()
