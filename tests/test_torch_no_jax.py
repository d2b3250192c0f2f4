"""The port stands alone: no module of ``src/repro_torch``, nor
``chip_smoke.py``, ``host_cost.py`` or ``quant_cost.py``, imports ``jax``, ``jaxlib`` or the
reference package ``repro``; and every entry point refuses to run
without a card unless the caller asks for ``device="cpu"``."""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "host_cost.py", ROOT / "quant_cost.py",
     ROOT / "tp_cards.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") \
                == "__import__" and node.args and \
                isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_module_imports_no_jax_nor_reference(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_scan_sees_every_kernel_source_module():
    names = {p.name for p in PORT_FILES}
    assert {"ops.py", "ref.py", "faultmodel.py", "_build.py", "cnn.py",
            "objectives.py", "chip_smoke.py", "host_cost.py",
            "transformer.py", "graph.py", "lm_setup.py", "registry.py",
            "base.py", "olmo_1b.py", "runtime.py", "engine.py",
            "kvcache.py", "monitor.py", "quant_cost.py", "optimizer.py",
            "train_step.py", "trainer.py", "compression.py", "ckpt.py",
            "train_lm.py", "mesh.py", "pipeline.py", "shardings.py",
            "steps.py", "roofline.py", "train.py", "collectives.py",
            "dryrun.py", "tp_cards.py"} <= names
    assert (ROOT / "src" / "repro_torch" / "launch" / "__init__.py") \
        in PORT_FILES


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch import cnn_setup, convert, quickstart, train_lm
    from repro_torch.core import (FaultSpec, InferenceAccuracyEvaluator,
                                  profile_layer_sensitivity)
    from repro_torch.configs import get_config
    from repro_torch.core import make_lm_accuracy_evaluator
    from repro_torch.lm_setup import lm_calibration_setup
    from repro_torch.models.cnn import CNN_MODELS
    from repro_torch.models.graph import lm_eval_strategy
    from repro_torch.models.transformer import init_cache, init_lm
    from repro_torch.launch import train as launch_train
    from repro_torch.train import AdamWConfig, Trainer, TrainerConfig

    lm_cfg = get_config("olmo-1b").reduced()
    lm_params = init_lm(lm_cfg, device="cpu")
    for model in CNN_MODELS.values():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.init(0, 8, width=0.25, img=16)
    params = CNN_MODELS["alexnet"].init(0, 8, width=0.25, img=16,
                                        device="cpu")
    x = np.zeros((2, 16, 16, 3), np.float32)
    y = np.zeros(2, np.int64)
    calls = [
        lambda: InferenceAccuracyEvaluator(CNN_MODELS["alexnet"].apply, params,
                                           x, y, FaultSpec(), [1.0, 0.35]),
        lambda: cnn_setup.make_evaluator("alexnet", params, FaultSpec(),
                                         n_eval=2),
        lambda: cnn_setup.eval_batch(2),
        lambda: cnn_setup.clean_argmax_labels("alexnet", params, 2),
        lambda: cnn_setup.clean_accuracy("alexnet", params, 2),
        lambda: cnn_setup.accuracy_under_partition(
            "alexnet", params, np.zeros(8, np.int64), 0.1, 0.1, n_eval=2),
        lambda: convert.params_from_jax({"w": np.zeros(2, np.float32)}),
        lambda: convert.quant_params_from_jax({"w": np.zeros(2, np.float32)}),
        lambda: profile_layer_sensitivity(CNN_MODELS["alexnet"].apply, params,
                                          x, y, 8, FaultSpec()),
        lambda: cnn_setup.get_trained("alexnet", steps=1),
        lambda: quickstart.main(["--steps", "1"]),
        lambda: init_lm(lm_cfg),
        lambda: init_cache(lm_cfg, 1, 8),
        lambda: lm_calibration_setup(lm_cfg),
        lambda: lm_eval_strategy(lm_cfg),
        lambda: make_lm_accuracy_evaluator(
            lm_cfg, lm_params, {"tokens": np.zeros((1, 4), np.int32)},
            np.zeros((1, 4), np.int64), FaultSpec(), [1.0, 0.5]),
        lambda: convert.opt_state_from_jax(
            {"m": {}, "v": {}, "step": np.int32(0)}),
        lambda: Trainer(lm_cfg, AdamWConfig(), TrainerConfig(), iter(())),
        lambda: Trainer(lm_cfg, AdamWConfig(), TrainerConfig(), iter(()),
                        params=lm_params),
        lambda: train_lm.main(["--steps", "1"]),
        lambda: launch_train.main(["--arch", "olmo-1b", "--steps", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # and with device="cpu" they run there
    t = Trainer(lm_cfg, AdamWConfig(), TrainerConfig(), iter(()),
                params=lm_params, device="cpu")
    assert t.device.type == "cpu" and t.opt_state["step"].device.type == "cpu"


def test_kernel_wrappers_take_only_cuda_or_cpu():
    """The fault kernels' dispatch is by device alone: CPU runs the plain
    version, CUDA the kernel; any other device raises (no silent plain
    path).  Every source ``_build`` compiles is there, without fast math
    (the glue kernels, bitwise their chains, run the chains off the card:
    ``test_torch_glue.py``)."""
    from repro_torch.kernels import _build, ops

    fake = torch.empty(4, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.bitflip(fake, 0, 0.1, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.quant_bitflip(fake.float(), 0, 0.1, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.fault_matmul(torch.empty(2, 4, device="meta"), fake.reshape(4, 1),
                         1.0, 0, 0.1, 4)
    assert _build.SOURCES == ("bitflip", "quant_bitflip", "fault_matmul",
                              "glue")
    for src in _build.SOURCES:
        assert (_build.CSRC / f"{src}.cu").is_file()
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
