"""North-star benchmark (BASELINE.json): simulate a 10k-patient EQ_4_D
PKPD cohort, discover its ODEs by STLSQ, and fine-tune every patient
(INSITE) on one GPU; target < 60 s (reference harness: ~96 s for INSITE on
a 1.2k-patient cohort on CPU, BASELINE.md wall-clock table).

Runs the workload twice in one process: the first run (compile included)
is reported as ``cold_s``, the second is the metric.  Fails without a GPU.

Prints ONE JSON line: {"metric", "patients", "value", "unit",
"vs_baseline", "cold_s", "stages_s", "rmse_orig", "device", "card"}.
vs_baseline > 1.0 means faster than the 60 s target.

    python bench.py                      # 10k patients, fused path
    BENCH_PATIENTS=500 python bench.py   # quick smoke
    BENCH_MODE=standard python bench.py  # collection + SINDyRegressor path
"""

import json
import os
import sys
from time import perf_counter

import numpy as np

from insite_tpu.utils import card_info, device_record, require_gpus


def fused(n_train):
    from insite_tpu.harness.northstar import fused_northstar
    r = fused_northstar(n_train, seed=0, equation_name='EQ_4_D',
                        projection_horizon=1)
    print(f"[bench] fused: sim+design+QR {r['t_sim_design']:.3f}s | "
          f"host STLSQ {r['t_stlsq']:.3f}s | fine-tune "
          f"{r['t_finetune']:.3f}s | metric {r['t_metric']:.3f}s",
          file=sys.stderr)
    print(f"[bench] {r['global_equation_string']}", file=sys.stderr)
    stages = {k: r['t_' + k]
              for k in ('sim_design', 'stlsq', 'finetune', 'metric')}
    return r['total'], stages, r['rmse_orig']


def standard(n_train):
    from insite_tpu.data import PkpdDatasetCollection
    from insite_tpu.eval.metrics import normalised_masked_rmse
    from insite_tpu.models.sindy import SINDyConfig, SINDyRegressor
    t0 = perf_counter()
    coll = PkpdDatasetCollection(
        conf_coeff=2.0,
        num_patients={'train': n_train, 'val': 100, 'test': 2},
        equation_str='EQ_4_D', seed=0)
    t1 = perf_counter()
    cfg = SINDyConfig(dataset_name='EQ_4_D', sindy_threshold=0.1,
                      sindy_alpha=0.5, lam=10.0, insite=True)
    model = SINDyRegressor(cfg, coll).fit(coll.train_f)
    t2 = perf_counter()
    preds = model._fine_tuned_rollout(coll.train_f, projection_horizon=1)
    t3 = perf_counter()
    rmse_orig, _ = normalised_masked_rmse(coll.train_f, np.asarray(preds))
    print(f"[bench] {model.global_equation_string}", file=sys.stderr)
    stages = {'simulate_process': t1 - t0, 'discover': t2 - t1,
              'finetune': t3 - t2}
    return t3 - t0, stages, rmse_orig


def main():
    devices = require_gpus(1)
    card = card_info()
    n_train = int(os.environ.get("BENCH_PATIENTS", 10_000))
    mode = os.environ.get("BENCH_MODE", "fused")
    run = {'fused': fused, 'standard': standard}[mode]
    cold, _, _ = run(n_train)
    total, stages, rmse_orig = run(n_train)
    print(f"[bench] factual normalised RMSE: orig={rmse_orig:.4f}% | card: "
          f"{card}", file=sys.stderr)
    print(json.dumps({
        "metric": ("eq4_simulate_discover_finetune_wall_s"
                   if mode == 'fused' else "eq4_standard_path_wall_s"),
        "patients": n_train,
        "value": total,
        "unit": "s",
        "vs_baseline": 60.0 / total,
        "cold_s": cold,
        "stages_s": stages,
        "rmse_orig": float(rmse_orig),
        "device": device_record(devices),
        "card": card,
    }))


if __name__ == "__main__":
    main()
