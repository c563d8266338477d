#!/usr/bin/env python
"""Matched-cohort MSM runs on the EQ_4 family (VERDICT r4 #6).

Context: the reference's shipped msm EQ_4 rows are bit-identical across
all 10 "seeds" (std 0.0 in results/2_main_table/final_with_insite.txt) —
its dataset cache (run.py `load_from_cache`) served ONE cohort to every
run, while our protocol draws a fresh cohort per seed.
`tools/pkpd_cohort_parity.py` proves our generator is bit-matching at
equal seed (exact treatments/lengths, statics to 1 ULP, volumes to 1e-13
over 60 steps; the reference generator is itself jax-based and forces
x64, pkpd_simulation.py:12-13).

This tool runs OUR MSM per seed on the f64 CPU lane (the same precision
the reference cohort cache was generated under) and reports each seed's
1-step RMSE next to the reference's single shared-cohort value, so
PARITY.md can state which cohort the reference's number corresponds to
and how far the per-cohort distribution spreads around it.

Usage: python tools/msm_matched_cohort.py [--datasets EQ_4_D ...]
       [--seeds 10] [--sklearn]  (--sklearn swaps in the reference's
       actual sklearn solvers to rule out solver-side deltas)
CPU-only (f64 host solves); leaves the GPU to other jobs.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)

import numpy as np

REF = {  # encoder_test_rmse_orig, constant across its 10 runs
    'EQ_4_A': 0.5626, 'EQ_4_B': 0.5639, 'EQ_4_C': 0.6727, 'EQ_4_D': 0.5213,
}


def use_sklearn_solvers():
    from sklearn.linear_model import LinearRegression, LogisticRegression
    import insite_tpu.models.msm as m

    def logistic_fit(X, Y, max_iter=100):
        W, b = [], []
        for k in range(np.asarray(Y).shape[1]):
            clf = LogisticRegression(penalty=None, max_iter=max_iter)
            clf.fit(np.asarray(X, np.float64), np.asarray(Y)[:, k] > 0.5)
            W.append(clf.coef_[0])
            b.append(clf.intercept_[0])
        return np.stack(W), np.asarray(b)

    def linreg_fit(X, Y, sample_weight=None):
        reg = LinearRegression()
        reg.fit(np.asarray(X, np.float64), np.asarray(Y, np.float64),
                sample_weight=sample_weight)
        return np.concatenate([reg.coef_.T,
                               np.atleast_1d(reg.intercept_)[None, :]])

    m.logistic_fit = logistic_fit
    m.linreg_fit = linreg_fit


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--datasets', nargs='+',
                   default=['EQ_4_A', 'EQ_4_B', 'EQ_4_C', 'EQ_4_D'])
    p.add_argument('--seeds', type=int, default=10)
    p.add_argument('--sklearn', action='store_true')
    args = p.parse_args()
    if args.sklearn:
        use_sklearn_solvers()
    from insite_tpu.harness.runner import run_experiment
    tag = 'sklearn-solver' if args.sklearn else 'our-solver'
    for ds in args.datasets:
        vals = []
        for seed in range(args.seeds):
            r = run_experiment(ds, 'msm', seed, 2.0)
            v = r.get('encoder_test_rmse_orig')
            vals.append(v)
            print(f'{ds} seed {seed} [{tag}] 1-step={v:.4f} '
                  f'(ref shared-cohort {REF[ds]})', flush=True)
        a = np.asarray(vals, np.float64)
        best = int(np.argmin(np.abs(a - REF[ds])))
        print(f'== {ds} [{tag}]: mean={a.mean():.4f} std={a.std():.4f} '
              f'span=[{a.min():.4f},{a.max():.4f}] ref={REF[ds]} '
              f'nearest seed={best} ({a[best]:.4f})', flush=True)


if __name__ == '__main__':
    main()
