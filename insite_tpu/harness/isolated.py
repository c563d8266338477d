"""Per-run process isolation for sweeps (``run.py --isolate``).

The reference runs each experiment inside a ``multiprocessing.Pool`` worker
(run.py:91-131), so a crashed run cannot poison the rest of the sweep.  Our
default is in-process execution (one in-memory compile cache, one device
client), but a device-level failure — e.g. a device out-of-memory — can
wedge the process's backend and fail every subsequent run.  ``--isolate``
restores the reference's blast-radius semantics: each run executes in a
fresh interpreter; the parent gets the metrics dict back over stdout, and
any child failure surfaces as a normal exception for the sweep's fault
wall to convert into an ``errored`` row.

The parent never initialises a JAX backend (it only spawns children and
tables their results), so each child alone holds the device: a JAX
process reserves most of a GPU's memory when it first uses it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

_MARKER = 'ISOLATED_RESULT:'


def _die_with_parent():
    """preexec hook: deliver SIGTERM to the child when its parent dies.

    `timeout` and job schedulers signal only the direct child (run.py) —
    without this, an isolated grandchild is orphaned and keeps holding the
    device, starving whatever runs next."""
    import ctypes
    import signal
    PR_SET_PDEATHSIG = 1
    ctypes.CDLL('libc.so.6', use_errno=True).prctl(PR_SET_PDEATHSIG,
                                                   signal.SIGTERM)


def run_isolated(dataset_name: str, method_name: str, seed: int,
                 domain_conf: float, cfg, experiment) -> dict:
    """Execute one run_experiment in a fresh interpreter, return its
    metrics dict. Raises RuntimeError on any child failure."""
    payload = json.dumps({
        'dataset_name': dataset_name,
        'method_name': method_name,
        'seed': seed,
        'domain_conf': domain_conf,
        'cfg': dataclasses.asdict(cfg),
        'experiment': experiment.name,
    })
    # the child resolves `insite_tpu` via PYTHONPATH (the package need not
    # be pip-installed, and the parent may have been launched from
    # anywhere via `python /path/to/run.py`)
    import insite_tpu
    pkg_parent = os.path.dirname(os.path.dirname(insite_tpu.__file__))
    env = dict(os.environ)
    env['PYTHONPATH'] = pkg_parent + os.pathsep + env.get('PYTHONPATH', '')
    timeout_s = float(os.environ.get('ISOLATED_TIMEOUT_S', 0)) or None
    try:
        proc = subprocess.run(
            [sys.executable, '-m', 'insite_tpu.harness.isolated'],
            input=payload, capture_output=True, text=True, env=env,
            preexec_fn=_die_with_parent, timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(
            f'isolated run timed out after {timeout_s:.0f}s '
            f'(ISOLATED_TIMEOUT_S); child killed') from e
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith(_MARKER):
            return json.loads(line[len(_MARKER):])
    raise RuntimeError(
        f'isolated run ({dataset_name}, {method_name}, seed {seed}) '
        f'failed with exit code {proc.returncode}; stderr tail:\n'
        f'{proc.stderr[-2000:]}')


def run_isolated_column(dataset_name: str, method_name: str, cfg):
    """Execute one vectorized (dataset, method) seed column in a fresh
    interpreter; returns ``(r, seeds)`` with ``r`` mapping metric name ->
    np.ndarray [S] (same contract as runner._vectorized_column).

    Raises the parent-side runner.ColumnSkipped when the child reports the
    column has no vectorized path, and RuntimeError on any other child
    failure — a crashed/wedged device client in the child cannot poison the
    parent's remaining columns (the round-3 failure mode).
    """
    import numpy as np
    payload = json.dumps({
        'mode': 'column',
        'dataset_name': dataset_name,
        'method_name': method_name,
        'cfg': dataclasses.asdict(cfg),
    })
    import insite_tpu
    pkg_parent = os.path.dirname(os.path.dirname(insite_tpu.__file__))
    env = dict(os.environ)
    env['PYTHONPATH'] = pkg_parent + os.pathsep + env.get('PYTHONPATH', '')
    timeout_s = float(os.environ.get('ISOLATED_TIMEOUT_S', 0)) or None
    try:
        proc = subprocess.run(
            [sys.executable, '-m', 'insite_tpu.harness.isolated'],
            input=payload, capture_output=True, text=True, env=env,
            preexec_fn=_die_with_parent, timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(
            f'isolated run timed out after {timeout_s:.0f}s '
            f'(ISOLATED_TIMEOUT_S); child killed') from e
    # the child streams run.py-style log lines on stderr; surface them so
    # the parent's sweep log keeps the per-column progress trail
    if proc.stderr:
        sys.stderr.write(proc.stderr)
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith(_MARKER):
            out = json.loads(line[len(_MARKER):])
            if out.get('skipped'):
                from insite_tpu.harness.runner import ColumnSkipped
                raise ColumnSkipped(out['skipped'])
            r = {k: np.asarray(v, np.float64)
                 for k, v in out['metrics'].items()}
            return r, out['seeds']
    raise RuntimeError(
        f'isolated column ({dataset_name}, {method_name}) failed with '
        f'exit code {proc.returncode}; stderr tail:\n'
        f'{proc.stderr[-2000:]}')


def _main():
    spec = json.loads(sys.stdin.read())
    from insite_tpu.harness.config import RunConfig
    if spec.get('mode') == 'column':
        import numpy as np
        from insite_tpu.harness.runner import (ColumnSkipped,
                                               _vectorized_column)
        try:
            r, seeds = _vectorized_column(RunConfig.from_dict(spec['cfg']),
                                          spec['dataset_name'],
                                          spec['method_name'])
        except ColumnSkipped as e:
            print(_MARKER + json.dumps({'skipped': str(e)}), flush=True)
            return
        out = {'metrics': {k: np.asarray(v, np.float64).tolist()
                           for k, v in r.items()
                           if isinstance(v, np.ndarray) and v.ndim == 1},
               'seeds': list(seeds)}
        print(_MARKER + json.dumps(out), flush=True)
        return
    from insite_tpu.harness.runner import Experiment, run_experiment
    result = run_experiment(spec['dataset_name'], spec['method_name'],
                            spec['seed'], spec['domain_conf'],
                            RunConfig.from_dict(spec['cfg']),
                            Experiment[spec['experiment']])
    print(_MARKER + json.dumps(result, default=float), flush=True)


if __name__ == '__main__':
    _main()
