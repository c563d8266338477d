"""tools/seed_gaps.py: the queue's per-cell seed accounting."""

import importlib.util
import os
import sys

import numpy as np
import pandas as pd

spec = importlib.util.spec_from_file_location(
    'seed_gaps', os.path.join(os.path.dirname(__file__), '..', 'tools',
                              'seed_gaps.py'))
seed_gaps = importlib.util.module_from_spec(spec)
spec.loader.exec_module(seed_gaps)


def test_counts_include_wsindy_tumor_cells():
    """Round 5 extends the weak form to the tumor family
    (models/sindy.py::_fit_weak_tumor), so wsindy x cancer_sim/EQ_5 are
    real main-table cells now (the reference skips them, run.py:100-103)."""
    df = pd.DataFrame({'method_name': ['wsindy'], 'dataset_name': ['EQ_4_A'],
                       'seed': [0]})
    c = seed_gaps.counts(df)
    assert c[('wsindy', 'cancer_sim')] == 0
    assert c[('wsindy', 'EQ_4_A')] == 1


def test_next_cell_consumes_priority_lines_one_shot(tmp_path, capsys,
                                                    monkeypatch):
    """logs/markers/priority_cells lines jump the thinness queue and are
    consumed exactly once per --next-cell read (the round-4 endgame
    dispatch mechanism: accelerator re-measures of suspect CPU-lane
    seeds, edct close-out chunks)."""
    monkeypatch.chdir(tmp_path)
    os.makedirs('logs/markers')
    with open('logs/markers/priority_cells', 'w') as f:
        f.write('ct EQ_4_D 8 std 5 2\nedct cancer_sim 2 std 2 3\n')
    monkeypatch.setattr(sys, 'argv', ['seed_gaps.py', '--next-cell'])
    seed_gaps.main()
    assert capsys.readouterr().out.strip() == 'ct EQ_4_D 8 std 5 2'
    seed_gaps.main()
    assert capsys.readouterr().out.strip() == 'edct cancer_sim 2 std 2 3'
    with open('logs/markers/priority_cells') as f:
        assert f.read() == ''            # both lines consumed


def test_plan_groups_consecutive_missing_runs(tmp_path, capsys, monkeypatch):
    df = pd.DataFrame({
        'method_name': ['crn'] * 3,
        'dataset_name': ['EQ_4_A'] * 3,
        'seed': [2, 3, 7],
    })
    monkeypatch.setattr(seed_gaps, 'protocol_df', lambda logs: df)
    monkeypatch.setattr(sys, 'argv',
                        ['seed_gaps.py', '--method', 'crn', '--plan'])
    seed_gaps.main()
    out = [l for l in capsys.readouterr().out.splitlines()
           if l.startswith('EQ_4_A')]
    # missing: 0-1, 4-6, 8-9 -> three consecutive ranges
    assert out == ['EQ_4_A 0 2', 'EQ_4_A 4 3', 'EQ_4_A 8 2']


def test_protocol_df_rejects_hparam_variant_sweeps(tmp_path):
    """A sweep whose fingerprint carries non-empty model_overrides
    (ref_tuned preset, basin experiments) is NOT main-table evidence,
    even at protocol scale: newest-wins dedup must never let variant
    rows shadow the honest default-hparam rows."""
    row = ("{'encoder_test_rmse_orig': 0.5, 'method': 'ct', 'seed': 0, "
           "'errored': False, 'dataset_name': 'EQ_4_D', "
           "'method_name': 'ct', 'domain_conf': 2.0}")
    proto = ('{"epochs": 100, "train_samples": 1000, "val_samples": 100, '
             '"test_samples": 100, "model_overrides": %s}')
    for name, mo in (('plain', '{}'),
                     ('variant', '{"ct": {"alpha": 0.001}}')):
        with open(tmp_path / f'run-{name}.txt', 'w') as f:
            f.write(f'2026-08-20 10:00:00,000 INFO [Sweep config] '
                    f'{proto % mo}\n')
            f.write(f'2026-08-20 10:00:01,000 INFO '
                    f'[Exp evaluation complete] {row}\n')
    df = seed_gaps.protocol_df(log_glob=str(tmp_path / 'run-*.txt'))
    assert len(df) == 1          # only the default-hparam sweep survives
