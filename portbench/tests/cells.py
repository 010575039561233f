"""Small cells for the harness's CPU tests: the two configurations cut
to sizes a test run holds and their traffic.  The small MLP carries its
own bfloat16 rounding, so the small cells have limits of their own, set
from CPU readings of the port (loss gaps up to 1.2e-4, worst-leaf gaps
up to 3.6e-2, median-leaf gaps under 1e-2 over seeds 3-7) with room."""

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _json(*parts):
    return json.loads(HERE.joinpath(*parts).read_text())


def small_cell(config: str, traffic: str, workload: str) -> dict:
    cfg = copy.deepcopy(_json("configs", f"{config}.json"))
    tr = copy.deepcopy(_json("traffic", f"{traffic}.json"))
    if cfg["model"] == "wide_deep":
        cfg.update(batch_size=256, field_size=8, vocab_size=5000,
                   deep_layer_dim=[64, 64])
        tr.update(ring=4, unique_bucket=2048)
    else:
        cfg.update(batch_size=128, emb_128_size=5000, emb64_single_size=3000,
                   emb64_multi_size=3000, deep_layer_dim=[64, 64])
        tr.update(ring=3)
    tr.update(warmup_steps=1, trace_steps=3, settle_s=0)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    return {"cell": {"chips": 1}, "config": cfg, "traffic": tr,
            "limits": SMALL_LIMITS,
            "end_to_end": e2e, "per_layer": []}


SMALL_LIMITS = {"loss_gap": 1e-3, "grad_gap": 0.1, "change_gap": 0.1,
                "grad_gap_median": 0.03, "change_gap_median": 0.03,
                "table_grad_gap": 0.03, "table_grad_err": 0.12,
                "untouched_moved": 0}

WD = ("wd_bench", "criteo", "wd_bench.criteo")
MT = ("mt_outbrain", "lossless", "mt_outbrain.lossless")
