"""The configurations and mixes at the sizes of the repository's CPU tests
(ResNet18 at width 0.25, 16 x 16 images, 8 of them; a 2-layer olmo-1b of
width 64 over 2 x 16 tokens), derived from the benchmark's own files."""
import copy
import json

from bench.harness import BENCH, ROOT


def bench_json() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def conf(name: str) -> dict:
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    c = copy.deepcopy(c)
    if name == "resnet18":
        c.update(width=0.25, stage_channels=[16, 32, 64, 128], img=16,
                 n_eval=8)
        c["check"]["rows"] = 6
    else:
        c["arch"].update(num_hidden_layers=2, hidden_size=64,
                         num_attention_heads=4, num_key_value_heads=4,
                         head_dim=16, intermediate_size=128, vocab_size=120,
                         embedding_size=128)
        c["calibration"] = {"batch": 2, "seq": 16}
        c["dtype"] = "float32"
        c["check"]["rows"] = 6
    c["evaluator"]["eval_batch_size"] = None
    return c


def traffic(name: str) -> dict:
    t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    t["population"] = 8
    if t["kind"] == "search":
        t["generations"] = 2
    return t
