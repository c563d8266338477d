"""Experiment orchestration.  The package attributes below are imported on
first use, so `insite_tpu.harness.northstar` and the runner's per-run path
load neither pandas (results tables) nor flax (neural baselines)."""

import importlib

_LAZY = {
    'Experiment': 'runner', 'run_experiment': 'runner', 'sweep': 'runner',
    'METHODS': 'runner',
    'ci': 'results', 'df_from_log': 'results',
    'generate_main_results_table': 'results',
}


def __getattr__(name):
    if name in _LAZY:
        module = importlib.import_module(f'{__name__}.{_LAZY[name]}')
        return getattr(module, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
