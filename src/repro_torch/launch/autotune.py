"""Per-cell configuration auto-tuning (``repro/launch/autotune.py`` at the
same path).

No single lowering wins everywhere: seq-sharded KV decode only pays when
KV heads don't divide the model axis, and over-decomposition trades live
memory for steps. A deployment therefore picks per-(arch x shape)
configs from the dry-run roofline; this module materializes that choice.

    PYTHONPATH=src python -m repro_torch.launch.autotune
      → build/repro_torch/tuned_configs.json
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict

from repro_torch.launch import roofline as R
from repro_torch.launch.dryrun import RESULTS

TUNED = os.path.join(os.path.dirname(RESULTS), "tuned_configs.json")


def tune(results_dir: str = RESULTS, chips: int = 8) -> Dict[str, Dict]:
    base = {(r["arch"], r["shape"]): r
            for r in R.build_table(results_dir, "baseline", chips)}
    opt = {(r["arch"], r["shape"]): r
           for r in R.build_table(results_dir, "opt", chips)}
    tuned: Dict[str, Dict] = {}
    for key, b in base.items():
        cands = {"baseline": b}
        if key in opt:
            cands["opt"] = opt[key]
        pick = min(cands, key=lambda k: cands[k]["step_time_bound_s"])
        r = cands[pick]
        tuned[f"{key[0]}__{key[1]}"] = {
            "config": pick,
            "step_bound_s": r["step_time_bound_s"],
            "bottleneck": r["bottleneck"],
            "roofline_fraction": r["roofline_fraction"],
            "speedup_vs_baseline": (
                b["step_time_bound_s"] / r["step_time_bound_s"]),
        }
    return tuned


def main():
    tuned = tune()
    with open(TUNED, "w") as f:
        json.dump(tuned, f, indent=2)
    n_opt = sum(1 for v in tuned.values() if v["config"] == "opt")
    sp = [v["speedup_vs_baseline"] for v in tuned.values()]
    print(f"tuned {len(tuned)} cells: {n_opt} pick 'opt', "
          f"{len(tuned) - n_opt} keep 'baseline'")
    print(f"geomean speedup vs always-baseline: "
          f"{math.exp(sum(math.log(x) for x in sp) / len(sp)):.2f}x")
    print(f"wrote {TUNED}")


if __name__ == "__main__":
    main()
