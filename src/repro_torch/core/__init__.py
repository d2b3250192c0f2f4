"""AFarePart core, the counterpart of ``repro.core``: fault model, cost
model, NSGA-II, the population and staged engines, ΔAcc objectives,
partitioners and the online reconfiguration loop."""
from repro_torch.core.costmodel import (CostModel, DeviceProfile, LayerInfo,
                                        EYERISS, SIMBA, TPU_V5E,
                                        TPU_V5E_LOWVOLT, TPU_V5E_MID,
                                        TPU_V5E_ECC, PAPER_DEVICES, POD_TIERS,
                                        POD_TIERS_4)
from repro_torch.core.eval_engine import (ActivationStore, DeviceScheduler,
                                          PopulationEvalEngine,
                                          PrefixEvalEngine, PrefixRef,
                                          StackedView, auto_eval_batch_size,
                                          device_memory_budget, parse_devices)
from repro_torch.core.fault import FaultSpec, FaultContext, PAPER_FAULT_SPEC
from repro_torch.core.nsga2 import (NSGA2Config, nsga2, nsga2_steps,
                                    fast_non_dominated_sort)
from repro_torch.core.objectives import (InferenceAccuracyEvaluator,
                                         ObjectiveFn,
                                         SurrogateAccuracyEvaluator,
                                         make_lm_accuracy_evaluator,
                                         profile_layer_sensitivity)
from repro_torch.core.partitioner import (AFarePart, CNNPartedLike,
                                          FaultUnawareBaseline, PartitionPlan,
                                          contiguous_stages, lm_partitioner)
from repro_torch.core.runtime import (FaultEnvironment, OnlineReconfigurator,
                                      ReconfigEvent, ReoptJob,
                                      simulate_deployment)

__all__ = [
    "CostModel", "DeviceProfile", "LayerInfo", "EYERISS", "SIMBA",
    "TPU_V5E", "TPU_V5E_LOWVOLT", "TPU_V5E_MID", "TPU_V5E_ECC",
    "PAPER_DEVICES", "POD_TIERS", "POD_TIERS_4",
    "PopulationEvalEngine", "PrefixEvalEngine", "ActivationStore",
    "PrefixRef", "StackedView", "DeviceScheduler", "auto_eval_batch_size",
    "device_memory_budget", "parse_devices", "FaultSpec", "FaultContext", "PAPER_FAULT_SPEC",
    "NSGA2Config", "nsga2", "nsga2_steps", "fast_non_dominated_sort",
    "InferenceAccuracyEvaluator", "SurrogateAccuracyEvaluator",
    "ObjectiveFn", "profile_layer_sensitivity", "make_lm_accuracy_evaluator",
    "AFarePart", "CNNPartedLike", "FaultUnawareBaseline", "PartitionPlan",
    "contiguous_stages", "lm_partitioner", "ReconfigEvent", "ReoptJob",
    "OnlineReconfigurator", "FaultEnvironment", "simulate_deployment",
]
