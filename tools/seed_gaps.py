"""Per-cell protocol seed-count accounting over the logs database.

The sweep logs are the results database (reference
utils/results_utils.py:108-172); this tool answers "which (dataset,
method) main-table cells still need seed runs to reach n=N" so queue
scripts dispatch only missing work and a re-run after a crash never
repeats landed columns.

Usage:
    python tools/seed_gaps.py                     # full gap table
    python tools/seed_gaps.py --method ct --list  # datasets with gaps,
                                                  # space-separated (for
                                                  # shell queues)
Protocol filtering matches process_result_file.py --protocol: sweep
fingerprints must be on-protocol (epochs=100, 1000/100/100 cohorts),
rows must have gamma == 2 and no noise/train-sample overrides; newest
row per (dataset, method, seed) wins by logging timestamp.
"""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

DATASETS = ('cancer_sim', 'EQ_5_A', 'EQ_5_B', 'EQ_5_C', 'EQ_5_D',
            'EQ_4_A', 'EQ_4_B', 'EQ_4_C', 'EQ_4_D')
METHODS = ('insite', 'sindy', 'wsindy', 'crn', 'msm', 'gnet', 'ct',
           'rmsn', 'edct')
PROTOCOL = {'epochs': 100, 'train_samples': 1000, 'val_samples': 100,
            'test_samples': 100}


def protocol_df(log_glob='logs/run-*.txt'):
    import pandas as pd
    from insite_tpu.harness.results import df_from_log
    from insite_tpu.harness.runner import _read_sweep_fingerprints
    frames = []
    for path in sorted(glob.glob(log_glob)):
        fps = _read_sweep_fingerprints(path)
        if any(any(fp.get(k) != v for k, v in PROTOCOL.items())
               for fp in fps):
            continue
        # hparam-variant sweeps (ref_tuned preset, basin experiments) are
        # not main-table evidence even at protocol scale: newest-wins
        # dedup must never let them shadow the honest default-hparam rows
        if any(fp.get('model_overrides') for fp in fps):
            continue
        d = df_from_log(path, with_ts=True)
        if not d.empty:
            frames.append(d)
    if not frames:
        return pd.DataFrame()
    df = pd.concat(frames, ignore_index=True)
    key = [c for c in ('dataset_name', 'method_name', 'seed',
                       'domain_conf', 'noise_scale', 'train_samples')
           if c in df.columns]
    df = df.sort_values('_log_ts', kind='stable') \
        .drop_duplicates(subset=key, keep='last').reset_index(drop=True)
    keep = df['domain_conf'].astype(float) == 2.0
    if 'noise_scale' in df.columns:
        keep &= df['noise_scale'].isna() | (df['noise_scale'] == 1.0)
    if 'train_samples' in df.columns:
        keep &= df['train_samples'].isna()
    if 'errored' in df.columns:
        keep &= ~df['errored'].fillna(False).astype(bool)
    return df[keep].reset_index(drop=True)


def counts(df):
    out = {}
    for m in METHODS:
        for ds in DATASETS:
            # round 5: wsindy tumor cells are now expected too (the
            # reference skips them, run.py:100-103; this repo extends the
            # weak form — models/sindy.py::_fit_weak_tumor)
            sub = df[(df.method_name == m) & (df.dataset_name == ds)] \
                if not df.empty else df
            out[(m, ds)] = 0 if df.empty else int(sub.seed.nunique())
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--target', type=int, default=10)
    p.add_argument('--method', default=None, choices=METHODS)
    p.add_argument('--list', action='store_true',
                   help='print only gap datasets, space-separated')
    p.add_argument('--plan', action='store_true',
                   help='print "dataset seed_start count" lines covering '
                        'the missing seeds of --method (for standard-path '
                        'top-up loops)')
    p.add_argument('--next-cell', action='store_true',
                   help='print the globally thinnest incomplete main-table '
                        'cell as "method dataset n mode start k": mode is '
                        '"std" for methods quarantined in logs/markers/'
                        'vectorized_exclude (start/k = first missing seed '
                        'range), else "vec". Empty output = all cells full.')
    p.add_argument('--logs', default='logs/run-*.txt')
    args = p.parse_args()

    if args.next_cell:
        # one-shot priority lines: logs/markers/priority_cells holds
        # full "method dataset n mode start k" dispatch specs that jump
        # the thinness queue (e.g. re-measuring a suspect CPU-lane seed
        # on the accelerator so newest-wins dedup can adjudicate a
        # platform-sensitive training basin). Each read consumes one line.
        pri = 'logs/markers/priority_cells'
        if os.path.exists(pri):
            with open(pri) as f:
                lines = [l.strip() for l in f if l.strip()]
            if lines:
                with open(pri, 'w') as f:
                    for l in lines[1:]:
                        f.write(l + '\n')
                print(lines[0])
                return

    df = protocol_df(args.logs)
    c = counts(df)
    if args.next_cell:
        excl = set()
        try:
            with open('logs/markers/vectorized_exclude') as f:
                excl = {l.strip() for l in f if l.strip()}
        except OSError:
            pass
        # tie order at equal n: proven-cheap methods before the
        # transformer families (edct's vectorized columns faulted a
        # 16 GiB device; ct's are unproven on-device). The flagship
        # method's cells get a -2 thinness bonus: an incomplete INSITE
        # main-table column costs the paper's own story more than a
        # baseline's, and its columns are ~10x cheaper than neural ones.
        tie = ('insite', 'sindy', 'wsindy', 'crn', 'msm', 'gnet', 'rmsn',
               'ct', 'edct')
        cells = [(c[(m, ds)] - (2 if m == 'insite' else 0),
                  tie.index(m), DATASETS.index(ds), m, ds, c[(m, ds)])
                 for m in tie for ds in DATASETS
                 if c[(m, ds)] is not None and c[(m, ds)] < args.target
                 and not os.path.exists(f'logs/markers/parked/{m}.{ds}')]
        if not cells:
            return
        _, _, _, m, ds, n = min(cells)
        # wsindy tumor columns have no vectorized path (the vec tumor
        # sweep is insite/sindy-only) — always standard
        mode = 'std' if (m in excl or
                         (m == 'wsindy' and 'EQ_4' not in ds)) else 'vec'
        have = set() if df.empty else set(
            df[(df.method_name == m) & (df.dataset_name == ds)]
            .seed.astype(int))
        missing = [s for s in range(args.target) if s not in have]
        start = missing[0]
        k = 1
        while k < len(missing) and missing[k] == start + k:
            k += 1
        print(f'{m} {ds} {n} {mode} {start} {k}')
        return
    if args.plan:
        if not args.method:
            raise SystemExit('--plan requires --method')
        # thinnest cells first (same rationale as --list): a fill loop
        # cut short by its budget costs the least-valuable tail
        order = [ds for ds in DATASETS if c[(args.method, ds)] is not None]
        order.sort(key=lambda ds: c[(args.method, ds)])
        for ds in order:
            have = set() if df.empty else set(
                df[(df.method_name == args.method)
                   & (df.dataset_name == ds)].seed.astype(int))
            missing = [s for s in range(args.target) if s not in have]
            # one line per consecutive missing-seed run
            while missing:
                start = missing[0]
                k = 1
                while k < len(missing) and missing[k] == start + k:
                    k += 1
                print(f'{ds} {start} {k}')
                missing = missing[k:]
        return
    if args.list:
        if not args.method:
            raise SystemExit('--list requires --method')
        # vectorized quarantine: methods listed in this marker file never
        # enter a vectorized stage (edct's vectorized columns faulted a
        # 16 GiB device; its cells are filled via the standard per-seed
        # path instead)
        try:
            with open('logs/markers/vectorized_exclude') as f:
                if args.method in {l.strip() for l in f if l.strip()}:
                    print('')
                    return
        except OSError:
            pass
        gaps = [ds for ds in DATASETS
                if c[(args.method, ds)] is not None
                and c[(args.method, ds)] < args.target]
        # thinnest cells first: going 0 -> 10 adds more evidence than
        # 5 -> 10, and a stage timeout then costs the least-valuable tail
        gaps.sort(key=lambda ds: c[(args.method, ds)])
        print(' '.join(gaps))
        return
    methods = [args.method] if args.method else list(METHODS)
    w = max(len(ds) for ds in DATASETS) + 2
    print('method'.ljust(8) + ''.join(ds.ljust(w) for ds in DATASETS))
    total = 0
    for m in methods:
        row = m.ljust(8)
        for ds in DATASETS:
            v = c[(m, ds)]
            row += ('-' if v is None else str(v)).ljust(w)
            if v is not None:
                total += max(0, args.target - v)
        print(row)
    print(f'missing seed-runs to n={args.target}: {total}')


if __name__ == '__main__':
    # queue scripts pipe us into head/tail; dying mid-print is expected
    import signal
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    main()
