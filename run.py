"""Benchmark sweep CLI — the reference run.py re-expressed over the
JAX framework.

Usage:
    python run.py --flush                         # 1-seed smoke sweep
    python run.py --methods insite sindy --datasets EQ_4_D --seeds 2
    python run.py --experiment INSIGHT_CONFOUNDING

Each run logs '[Exp evaluation complete] {...}' lines (the results
database, parseable by insite_tpu.harness.results.df_from_log) and emits
the LaTeX main tables at the end (run.py:132-134 in the reference).
"""

import argparse

from insite_tpu.harness.config import RunConfig
from insite_tpu.harness.logging_utils import (create_logger_in_process,
                                              generate_log_file_path)
from insite_tpu.harness.runner import Experiment, sweep


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--config', default=None,
                   help='YAML file of RunConfig fields (CLI flags override)')
    p.add_argument('--methods', nargs='+', default=None)
    p.add_argument('--datasets', nargs='+', default=None)
    p.add_argument('--seeds', type=int, default=None)
    p.add_argument('--seed-start', type=int, default=None)
    p.add_argument('--epochs', type=int, default=None)
    p.add_argument('--train-samples', type=int, default=None)
    p.add_argument('--val-samples', type=int, default=None)
    p.add_argument('--test-samples', type=int, default=None)
    p.add_argument('--domain-conf', type=float, default=None)
    p.add_argument('--experiment', default=None,
                   choices=[e.name for e in Experiment])
    p.add_argument('--flush', action='store_true', help='CI fast path')
    p.add_argument('--no-debug', action='store_true',
                   help='fault-isolate failing runs instead of raising')
    p.add_argument('--cache', action='store_true',
                   help='cache dataset collections on disk')
    p.add_argument('--tune', action='store_true',
                   help='hparam tuning on val (insite: vmapped lam-grid; '
                        'neural: seeded grid search, --tune-trials each)')
    p.add_argument('--tune-algo', choices=('grid', 'sha'), default=None,
                   help='neural tuner: flat seeded grid (default) or '
                        'adaptive successive halving (small epoch budgets '
                        'first, survivors promoted)')
    p.add_argument('--tune-trials', type=int, default=None,
                   help='neural tuning trials subsampled from the grid')
    p.add_argument('--vectorized', action='store_true',
                   help='run each (dataset, method) column as ONE '
                        'on-device multi-seed dispatch (insite/sindy/ct; '
                        'ODE columns use jax-native cohorts)')
    p.add_argument('--isolate', action='store_true',
                   help='run each experiment in a fresh interpreter so a '
                        'device-level failure (e.g. HBM OOM) cannot wedge '
                        'the rest of the sweep')
    p.add_argument('--resume', default=None, metavar='LOG',
                   help='reuse completed runs from a previous sweep log '
                        'and run only the rest')
    p.add_argument('--platform', default=None, choices=('cpu', 'gpu'),
                   help='force the jax backend (default: JAX picks the GPU '
                        'when there is one); "cpu" runs the sweep on the '
                        'host, f32, one device')
    args = p.parse_args()
    if args.platform:
        # insite_tpu has imported jax already, so the environment variable
        # alone comes too late for this process; --isolate children
        # inherit it
        import os

        import jax
        os.environ['JAX_PLATFORMS'] = args.platform
        jax.config.update('jax_platforms', args.platform)

    cfg = (RunConfig.from_yaml(args.config) if args.config else RunConfig())
    if args.methods:
        cfg.methods = tuple(args.methods)
    if args.datasets:
        cfg.datasets = tuple(args.datasets)
    if args.seeds is not None:
        cfg.seed_runs = args.seeds
    # None defaults: a flag only overrides the (possibly YAML-loaded)
    # config when explicitly given; store_true flags can only enable
    for k in ('seed_start', 'epochs', 'train_samples', 'val_samples',
              'test_samples', 'domain_conf'):
        v = getattr(args, k)
        if v is not None:
            setattr(cfg, k, v)
    if args.experiment is not None:
        cfg.experiment = args.experiment
    if args.flush:
        cfg.flush_mode = True
    if args.no_debug:
        cfg.debug_mode = False
    if args.cache:
        cfg.load_from_cache = True
    if args.tune:
        cfg.tune_hparams = True
    if args.tune_trials is not None:
        cfg.tune_trials = args.tune_trials
    if args.tune_algo is not None:
        cfg.tune_algo = args.tune_algo
    if args.isolate:
        cfg.isolate_runs = True
        # isolation is pointless if the first child failure re-raises:
        # imply the fault wall so failures become errored rows
        cfg.debug_mode = False
    if args.resume:
        cfg.resume_log = args.resume

    log_path = generate_log_file_path('run', cfg.log_dir)
    logger = create_logger_in_process(log_path)
    logger.info(f'Starting sweep | log at {log_path}'
                + (f' | platform={args.platform}' if args.platform else ''))
    if args.vectorized:
        from insite_tpu.harness.runner import vectorized_sweep
        df, tables = vectorized_sweep(cfg, log=logger)
    else:
        df, tables = sweep(cfg, Experiment[cfg.experiment], log=logger)
    for metric, table in tables.items():
        logger.info(f'Latex Table:: {metric}\n{table}')
    logger.info(f'[Log found at] {log_path}')


if __name__ == '__main__':
    main()
