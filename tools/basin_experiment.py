#!/usr/bin/env python
"""Controlled experiment on the ct/crn EQ_4_D seeds-5/6 adversarial basin
(VERDICT r4 #5).

PARITY.md root-caused the 3-10x outlier rows: deterministic,
platform-independent, cohort-determined (the two heaviest-tumor EQ_4_D
cohorts), specific to the two adversarial-BR methods, and localized at
the terminal time step.  Open question: is the basin escapable WITHIN the
reference's training recipe, or inherent to it?

This tool sweeps ONE stabilizer — the adversarial balancing strength
alpha (the reference's exp.alpha, ct.py config + AlphaRise callback;
update_alpha keeps its ramp) — at fixed everything-else on exactly those
(method, seed) cells:

    alpha = 0.01   (reference recipe — the logged baseline rows)
    alpha = 0.001  (10x weaker adversary)
    alpha = 0.0    (adversary off — causal control: if the divergence
                    persists here it is not the adversarial term at all)

Runs at full protocol scale but logs to logs/basin_r5-<ts>.txt, which the
results database never globs (logs/run-*.txt), and carries a non-empty
model_overrides fingerprint, which the protocol filters now reject
(tools/seed_gaps.py / process_result_file.py --protocol) — variant rows
can never shadow the honest main-table rows.

Usage: python tools/basin_experiment.py [--methods ct crn]
           [--seeds 5 6] [--alphas 0.001 0.0] [--platform cpu]
(PARITY: these cells reproduce bit-identically across platforms.)
"""

import argparse
import os
import json
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--methods', nargs='+', default=['ct', 'crn'])
    p.add_argument('--seeds', type=int, nargs='+', default=[5, 6])
    p.add_argument('--alphas', type=float, nargs='+', default=[0.001, 0.0])
    p.add_argument('--dataset', default='EQ_4_D')
    p.add_argument('--platform', default='cpu', choices=('cpu', 'gpu'))
    p.add_argument('--smoke', action='store_true',
                   help='tiny cohorts/epochs — plumbing validation only')
    args = p.parse_args()

    import jax
    jax.config.update('jax_platforms', args.platform)

    from insite_tpu.harness.config import RunConfig
    from insite_tpu.harness.logging_utils import (
        create_logger_in_process, generate_log_file_path)
    from insite_tpu.harness.runner import run_experiment

    log_path = generate_log_file_path(name='basin_r5')
    logger = create_logger_in_process(log_path)
    for alpha in args.alphas:
        for method in args.methods:
            mo = {method: {'alpha': alpha}}
            cfg = RunConfig(model_overrides=mo)
            if args.smoke:
                cfg.epochs = 1
                cfg.train_samples, cfg.val_samples, cfg.test_samples = \
                    60, 10, 10
            logger.info('[Sweep config] ' + json.dumps({
                'experiment': 'BASIN_EXPERIMENT', 'epochs': cfg.epochs,
                'train_samples': cfg.train_samples,
                'val_samples': cfg.val_samples,
                'test_samples': cfg.test_samples,
                'model_overrides': mo}, sort_keys=True))
            for seed in args.seeds:
                logger.info(f'[Now evaluating exp] '
                            f'({args.dataset!r}, {method!r}, {seed}, 2.0) '
                            f'alpha={alpha}')
                t0 = time.time()
                try:
                    r = run_experiment(args.dataset, method, seed, 2.0,
                                       cfg=cfg)
                except Exception as e:              # noqa: BLE001
                    logger.info(f'[Exp errored] {type(e).__name__}: {e}')
                    continue
                r.setdefault('dataset_name', args.dataset)
                r.setdefault('method_name', method)
                r.setdefault('seed', seed)
                r.setdefault('domain_conf', 2.0)
                r['alpha_override'] = alpha
                r['seconds_taken'] = round(time.time() - t0, 1)
                logger.info(f'[Exp evaluation complete] {r}')
    logger.info(f'[Log found at] {log_path}')
    print(log_path)


if __name__ == '__main__':
    main()
