"""Experiment orchestrator: enumerate (dataset, method, seed, gamma) runs,
dispatch to the per-method pipeline, isolate faults, aggregate results.

Re-design of the reference run.py:45-307 + the per-method runnables
(runnables/train_*.py): every method follows seed -> dataset collection
(cached) -> infer dims -> fit -> 1-step RMSE -> n-step RMSEs -> flat metrics
dict; the sweep log lines double as the results database
('[Exp evaluation complete] {...}', parsed back by results.df_from_log).
"""

from __future__ import annotations

import logging
import time
import traceback
from enum import Enum

import numpy as np

from insite_tpu.data import make_collection
from insite_tpu.harness.config import (RunConfig, SINDY_ALPHA,
                                       sindy_params_for)

logger = logging.getLogger('insite_tpu')

METHODS = ('sindy', 'insite', 'wsindy', 'msm', 'ct', 'crn', 'rmsn', 'gnet',
           'edct')


class Experiment(Enum):
    MAIN_TABLE = 1
    INSIGHT_CONFOUNDING = 2
    ABLATION_ONE_ODE = 3
    ABLATION_MORE_COMPLEX_BASIS_FUNCTIONS = 4
    INSIGHT_RECOVER_PARAMETRIC_DIST = 5
    INSIGHT_NOISE = 6
    INSIGHT_LESS_SAMPLES = 7


def _dims_from_collection(coll, with_vitals=False):
    d = coll.train_f.data
    dims = dict(dim_outcome=d['outputs'].shape[-1],
                dim_treatments=d['current_treatments'].shape[-1],
                dim_static_features=d['static_features'].shape[-1])
    if with_vitals and 'vitals' in d:
        dims['dim_vitals'] = d['vitals'].shape[-1]
    return dims


def _collection_for(dataset_name, method_name, seed, domain_conf,
                    cfg: RunConfig, experiment: Experiment):
    # sindy-family runs multiclass; everything else multilabel
    # (run.py:198-263 override assembly)
    if method_name in ('sindy', 'insite', 'wsindy'):
        treatment_mode = ('multilabel'
                          if experiment == Experiment.ABLATION_ONE_ODE
                          else 'multiclass')
    else:
        treatment_mode = 'multilabel'
    num_patients = {'train': cfg.train_samples, 'val': cfg.val_samples,
                    'test': cfg.test_samples}
    key = (dataset_name, treatment_mode, seed, float(domain_conf),
           tuple(sorted(num_patients.items())), cfg.cf_seq_mode,
           cfg.noise_scale)
    if cfg.load_from_cache and not cfg.force_recache:
        from insite_tpu.harness.cache import get_cached
        coll = get_cached(key)
        if coll is not None:
            return coll
    coll = make_collection(dataset_name, num_patients, seed,
                           coeff=float(domain_conf),
                           treatment_mode=treatment_mode,
                           cf_seq_mode=cfg.cf_seq_mode,
                           noise_scale=cfg.noise_scale)
    if cfg.load_from_cache or cfg.force_recache:
        from insite_tpu.harness.cache import put_cached
        put_cached(key, coll)
    return coll


def _merged_overrides(cfg: RunConfig, method_name: str, dataset_name: str,
                      domain_conf: float) -> dict:
    """Flatten `cfg.model_overrides` for one run, least-specific key
    first (`<m>` < `<m>@<ds>` < `<m>@<ds>/<coeff>`)."""
    mo = cfg.model_overrides or {}
    coeff = '%g' % float(domain_conf)
    merged = {}
    for key in (method_name, f'{method_name}@{dataset_name}',
                f'{method_name}@{dataset_name}/{coeff}'):
        merged.update(mo.get(key, {}))
    return merged


def _apply_model_overrides(mcfg, cfg: RunConfig, method_name: str,
                           dataset_name: str, domain_conf: float):
    """Tuned-hparam overlays (the reference's per-dataset/per-coefficient
    `+backbone/<m>_hparams/<ds>_domain_conf/<coeff>.yaml` mechanics,
    run.py:197-263): merge `cfg.model_overrides` entries onto the model
    config, least-specific key first."""
    import dataclasses
    merged = _merged_overrides(cfg, method_name, dataset_name, domain_conf)
    if not merged:
        return mcfg
    valid = {f.name for f in dataclasses.fields(mcfg)}
    unknown = set(merged) - valid
    if unknown:
        raise ValueError(f'unknown {type(mcfg).__name__} fields in '
                         f'model_overrides: {sorted(unknown)}')
    return dataclasses.replace(mcfg, **merged)


def _build_model(method_name, dataset_name, coll, cfg: RunConfig,
                 experiment: Experiment, seed: int,
                 domain_conf: float = 2.0):
    def _ov(mcfg):
        return _apply_model_overrides(mcfg, cfg, method_name, dataset_name,
                                      domain_conf)

    # processing entry point per method family (train_*.py:39-49)
    if method_name in ('crn', 'edct', 'rmsn'):
        if not coll.processed_data_encoder:
            coll.process_data_encoder()
    else:
        if not coll.processed_data_multi:
            coll.process_data_multi(
                include_continuous_treatment=(
                    'EQ_5' in dataset_name and
                    method_name in ('sindy', 'insite', 'wsindy')))
    dims = _dims_from_collection(coll)
    if method_name in ('sindy', 'insite', 'wsindy'):
        from insite_tpu.models.sindy import SINDyConfig, SINDyRegressor
        thr, lam = sindy_params_for(dataset_name)
        mcfg = SINDyConfig(
            dataset_name=(dataset_name if dataset_name != 'cancer_sim'
                          else 'CANCER_SIM'),
            sindy_threshold=thr, sindy_alpha=SINDY_ALPHA, lam=lam,
            insite=(method_name == 'insite'),
            wsindy=(method_name == 'wsindy'),
            joint_model=(experiment == Experiment.ABLATION_ONE_ODE),
            ablation_more_complex_basis_functions=(
                experiment ==
                Experiment.ABLATION_MORE_COMPLEX_BASIS_FUNCTIONS),
            treatment_mode=coll.treatment_mode)
        return SINDyRegressor(_ov(mcfg), coll)
    if method_name == 'ct':
        from insite_tpu.models.ct import CTConfig, CausalTransformer
        return CausalTransformer(
            _ov(CTConfig(epochs=cfg.epochs, seed=seed,
                         treatment_mode=coll.treatment_mode,
                         **_dims_from_collection(coll, with_vitals=True))),
            coll)
    if method_name == 'crn':
        from insite_tpu.models.crn import CRN, CRNConfig
        return CRN(_ov(CRNConfig(epochs=cfg.epochs, seed=seed,
                                 treatment_mode=coll.treatment_mode,
                                 **dims)), coll)
    if method_name == 'edct':
        from insite_tpu.models.edct import EDCT, EDCTConfig
        return EDCT(_ov(EDCTConfig(epochs=cfg.epochs, seed=seed,
                                   treatment_mode=coll.treatment_mode,
                                   **dims)), coll)
    if method_name == 'rmsn':
        from insite_tpu.models.rmsn import RMSN, RMSNConfig
        return RMSN(_ov(RMSNConfig(epochs=cfg.epochs, seed=seed,
                                   treatment_mode=coll.treatment_mode,
                                   **dims)), coll)
    if method_name == 'gnet':
        from insite_tpu.models.gnet import GNet, GNetConfig
        return GNet(_ov(GNetConfig(
            epochs=cfg.epochs, seed=seed, mc_samples=cfg.gnet_mc_samples,
            **_dims_from_collection(coll, with_vitals=True))), coll)
    if method_name == 'msm':
        from insite_tpu.models.msm import MSM, MSMConfig
        return MSM(_ov(MSMConfig(max_epochs=cfg.epochs, **dims)), coll)
    raise NotImplementedError(method_name)


def run_experiment(dataset_name: str, method_name: str, seed: int,
                   domain_conf: float, cfg: RunConfig = None,
                   experiment: Experiment = Experiment.MAIN_TABLE) -> dict:
    """One (dataset, method, seed, gamma) run; the per-method train+eval
    pipeline of runnables/train_*.py distilled to its shared skeleton."""
    cfg = cfg or RunConfig()
    t0 = time.perf_counter()
    np.random.seed(seed)
    coll = _collection_for(dataset_name, method_name, seed, domain_conf,
                           cfg, experiment)
    results = {}
    from insite_tpu.harness.tuning import NEURAL_HPARAM_GRIDS
    if cfg.tune_hparams and method_name in NEURAL_HPARAM_GRIDS:
        # the reference's Ray/Optuna `finetune` for the neural methods
        # (time_varying_model.py:319-395): seeded subsampled grid search,
        # selecting on validation factual RMSE, winner used for eval
        import dataclasses
        from insite_tpu.harness.tuning import grid_search

        def build_and_fit(params_):
            mo = dict(cfg.model_overrides or {})
            mo[method_name] = {**mo.get(method_name, {}), **params_}
            cfg_t = dataclasses.replace(cfg, model_overrides=mo)
            m = _build_model(method_name, dataset_name, coll, cfg_t,
                             experiment, seed, domain_conf=domain_conf)
            m.fit(coll.train_f, coll.val_f)
            return m

        if cfg.tune_algo == 'sha':
            from insite_tpu.harness.tuning import successive_halving_search
            best_params, model, _ = successive_halving_search(
                build_and_fit, NEURAL_HPARAM_GRIDS[method_name],
                coll.val_f, n_trials=cfg.tune_trials, seed=seed,
                max_budget=cfg.epochs,
                min_budget=max(1, cfg.epochs // 9))
        else:
            best_params, model, _ = grid_search(
                build_and_fit, NEURAL_HPARAM_GRIDS[method_name],
                coll.val_f, n_trials=cfg.tune_trials, seed=seed)
        results['tuned_hparams'] = best_params
    else:
        model = _build_model(method_name, dataset_name, coll, cfg,
                             experiment, seed, domain_conf=domain_conf)
        model.fit(coll.train_f, coll.val_f)

    if cfg.tune_hparams and method_name == 'insite':
        # Ray-Tune equivalent (time_varying_model.py:319-395): one vmapped
        # dispatch scores the whole lam grid on the validation cohort.
        from insite_tpu.harness.tuning import tune_insite_lam
        best_lam, _ = tune_insite_lam(model, coll.val_f)
        results['tuned_lam'] = best_lam
    rmse_orig, rmse_all, rmse_last = model.get_normalised_masked_rmse(
        coll.test_cf_one_step, one_step_counterfactual=True)
    results.update({'encoder_test_rmse_all': rmse_all,
                    'encoder_test_rmse_orig': rmse_orig,
                    'encoder_test_rmse_last': rmse_last})

    n_step = model.get_normalised_n_step_rmses(coll.test_cf_treatment_seq)
    results.update({f'decoder_test_rmse_{k + 2}-step': float(v)
                    for k, v in enumerate(np.asarray(n_step))})

    if hasattr(model, 'global_equation_string'):
        results['global_equation_string'] = model.global_equation_string
        results['fine_tuned'] = getattr(model, 'insite', False)
    if method_name == 'rmsn':
        # VERDICT r2: every rmsn row must say which stabilized-weight
        # formula it ran (shipped default 'likelihood' vs the reference's
        # 'score_ratio' parity mode) — the two differ by ~4x on EQ_4
        results['sw_mode'] = model.cfg.sw_mode
    if experiment == Experiment.INSIGHT_RECOVER_PARAMETRIC_DIST and \
            method_name == 'insite':
        # per-patient coefficient distribution on the validation cohort
        # (the reference only debug-printed these, sindy.py:679-683)
        c = model.get_fine_tuned_coefficients(coll.val_f)
        results['coef_mean'] = np.mean(c, axis=0).round(6).tolist()
        results['coef_std'] = np.std(c, axis=0).round(6).tolist()
        if getattr(coll.val_f, 'sim_params', None) is not None and \
                'hidden_C_0' in coll.val_f.sim_params:
            # recovered vs true per-arm decay constants (EQ_4 family;
            # harness/insights.py — collections cached before sim_params
            # existed skip this block)
            from insite_tpu.harness.insights import recover_parametric_dist
            rec = recover_parametric_dist(model, coll.val_f)
            for arm, stats in rec.items():
                for k, v in stats.items():
                    results[f'recover_{arm}_{k}'] = v
    results.update({'method': method_name, 'seed': seed,
                    'seconds_taken': time.perf_counter() - t0})
    if cfg.metrics_jsonl:
        from insite_tpu.harness.metrics_logger import MetricsLogger
        ml = MetricsLogger(cfg.metrics_jsonl,
                           run_name=f'{method_name}-{dataset_name}-{seed}')
        ml.log_params({'dataset_name': dataset_name, 'method': method_name,
                       'seed': seed, 'domain_conf': domain_conf})
        ml.log_metrics(results)
        ml.finish()
    return results


def _sweep_fingerprint(cfg: RunConfig, experiment_name: str) -> dict:
    return {
        'experiment': experiment_name, 'epochs': cfg.epochs,
        'train_samples': cfg.train_samples, 'val_samples': cfg.val_samples,
        'test_samples': cfg.test_samples, 'cf_seq_mode': cfg.cf_seq_mode,
        'noise_scale': cfg.noise_scale, 'tune_hparams': cfg.tune_hparams,
        'model_overrides': cfg.model_overrides or {},
    }


def _log_fingerprint(cfg: RunConfig, experiment_name: str, log):
    import json
    log.info('[Sweep config] ' +
             json.dumps(_sweep_fingerprint(cfg, experiment_name),
                        sort_keys=True))


def _read_sweep_fingerprints(log_path: str):
    """ALL '[Sweep config] {json}' lines of a sweep log (a log file can
    accumulate several appended sweeps, each writing rows under its own
    config); [] for logs written before fingerprinting existed. Resume
    must verify EVERY fingerprint in the log — trusting only the last one
    would reuse rows written under an earlier, different config."""
    import json
    tag = '[Sweep config] '
    fps = []
    try:
        with open(log_path) as f:
            for line in f:
                if tag in line:
                    try:
                        fp = json.loads(line.split(tag, 1)[1])
                    except json.JSONDecodeError:
                        continue
                    if fp not in fps:
                        fps.append(fp)
    except OSError:
        return []
    return fps


def sweep(cfg: RunConfig = None, experiment=Experiment.MAIN_TABLE,
          log=None):
    """The full benchmark sweep with per-run fault isolation
    (run.py:90-137, 154-171)."""
    import pandas as pd
    cfg = cfg or RunConfig()
    log = log or logger
    if cfg.flush_mode:
        cfg.flush()

    args_for_runs = []
    if experiment in (Experiment.MAIN_TABLE, Experiment.ABLATION_ONE_ODE,
                      Experiment.ABLATION_MORE_COMPLEX_BASIS_FUNCTIONS,
                      Experiment.INSIGHT_RECOVER_PARAMETRIC_DIST):
        for seed in range(cfg.seed_start, cfg.seed_start + cfg.seed_runs):
            for dataset_name in cfg.datasets:
                for method_name in cfg.methods:
                    # (the reference skips wsindy off the EQ_4 family,
                    # run.py:100-103; this repo extends the weak form to
                    # the tumor datasets — models/sindy.py::_fit_weak_tumor)
                    args_for_runs.append((dataset_name, method_name, seed,
                                          cfg.domain_conf))
    elif experiment == Experiment.INSIGHT_CONFOUNDING:
        for seed in range(cfg.seed_start, cfg.seed_start + cfg.seed_runs):
            for domain_conf in cfg.domain_confs:
                for method_name in cfg.methods:
                    args_for_runs.append(('EQ_4_D', method_name, seed,
                                          domain_conf))
    elif experiment == Experiment.INSIGHT_NOISE:
        # observation-noise robustness sweep on the noisy EQ_4 variant
        for seed in range(cfg.seed_start, cfg.seed_start + cfg.seed_runs):
            for noise_scale in cfg.noise_scales:
                for method_name in cfg.methods:
                    args_for_runs.append(('EQ_4_B', method_name, seed,
                                          cfg.domain_conf,
                                          {'noise_scale': noise_scale}))
    elif experiment == Experiment.INSIGHT_LESS_SAMPLES:
        # sample-efficiency sweep on EQ_4_D
        for seed in range(cfg.seed_start, cfg.seed_start + cfg.seed_runs):
            for n_train in cfg.train_sample_grid:
                for method_name in cfg.methods:
                    args_for_runs.append(('EQ_4_D', method_name, seed,
                                          cfg.domain_conf,
                                          {'train_samples': n_train}))

    # a typo'd overlay key would otherwise silently apply nothing while the
    # user believes tuned hparams were used — warn on keys no run matches
    if cfg.model_overrides:
        possible = set()
        for run_args in args_for_runs:
            ds, m, _, gamma = run_args[:4]
            possible |= {m, f'{m}@{ds}', f'{m}@{ds}/{"%g" % float(gamma)}'}
        unmatched = set(cfg.model_overrides) - possible
        if unmatched:
            log.warning(f'[sweep] model_overrides keys matching no run in '
                        f'this sweep: {sorted(unmatched)}')

    # config fingerprint logged into every sweep log: resume compares it so
    # rows computed under different settings (e.g. a --flush smoke run) are
    # never silently reused as this sweep's results
    fingerprint = _sweep_fingerprint(cfg, experiment.name)
    import json
    # read the resumed log's fingerprints BEFORE logging ours: resuming
    # into the same log file must not see its own fingerprint as previous
    prev_fps = _read_sweep_fingerprints(cfg.resume_log) if cfg.resume_log \
        else []
    log.info(f'[Sweep config] {json.dumps(fingerprint, sort_keys=True)}')

    # sweep resume: reuse completed rows from a previous log, skip their
    # runs (errored rows are re-run; the reference's only option is a full
    # re-sweep — its completed runs live only in the log, SURVEY.md §5)
    done = {}
    if cfg.resume_log:
        from insite_tpu.harness.results import df_from_log

        def _key(ds, method, seed, gamma, overrides):
            extra = tuple(sorted(
                (k, float(v)) for k, v in overrides.items()))
            return (ds, method, int(seed), float(gamma), extra)

        # override-swept fields (noise_scale, train_samples) live in the
        # per-row resume key, so a grid difference is fine; everything
        # else must match exactly — against EVERY fingerprint in the log,
        # since any of them may have written rows we would reuse
        skip = {'noise_scale', 'train_samples'} \
            if experiment.name.startswith('INSIGHT_') else set()
        fp_mismatch = {}
        for prev_fp in prev_fps:
            for k in fingerprint:
                if k not in skip and prev_fp.get(k) != fingerprint[k]:
                    fp_mismatch[k] = prev_fp.get(k)
        if not prev_fps:
            log.warning(f'[Resume] {cfg.resume_log} carries no '
                        f'[Sweep config] fingerprint (pre-fingerprint log); '
                        f'reusing rows WITHOUT config verification')
        if fp_mismatch:
            log.warning(
                f'[Resume] REFUSING to reuse rows from {cfg.resume_log}: '
                f'one of its {len(prev_fps)} sweep config(s) differs on '
                f'{sorted(fp_mismatch)} (theirs={fp_mismatch} '
                f'vs ours={ {k: fingerprint[k] for k in fp_mismatch} }); '
                f'all runs will execute fresh')
        else:
            for row in df_from_log(cfg.resume_log).to_dict('records'):
                if not row.get('errored', False):
                    ov = {k: row[k]
                          for k in ('noise_scale', 'train_samples')
                          if k in row and not pd.isna(row[k])}
                    # drop NaN / stringified-'nan' metric cells so reused
                    # rows cannot poison the groupby-mean aggregation
                    row = {k: v for k, v in row.items()
                           if not (v == 'nan' or
                                   (isinstance(v, float) and pd.isna(v)))}
                    done[_key(row['dataset_name'], row['method_name'],
                              row['seed'], row['domain_conf'], ov)] = row
            log.info(f'[Resume] {len(done)} completed runs found in '
                     f'{cfg.resume_log}')

    results = []
    for args in args_for_runs:
        dataset_name, method_name, seed, domain_conf = args[:4]
        overrides = args[4] if len(args) > 4 else {}
        if done:
            key = _key(dataset_name, method_name, seed, domain_conf,
                       overrides)
            if key in done:
                # re-log the reused row so the new log is self-contained
                log.info(f'[Exp evaluation complete] {done[key]}')
                results.append(done[key])
                continue
        run_cfg = cfg
        if overrides:
            from dataclasses import replace
            run_cfg = replace(cfg, **overrides)
        log.info(f'[Now evaluating exp] {args}')
        try:
            if run_cfg.isolate_runs:
                from insite_tpu.harness.isolated import run_isolated
                result = run_isolated(dataset_name, method_name, seed,
                                      domain_conf, run_cfg, experiment)
            else:
                result = run_experiment(dataset_name, method_name, seed,
                                        domain_conf, run_cfg, experiment)
            result['errored'] = False
            result.update(overrides)
        except Exception as e:          # fault wall (run.py:159-169)
            if cfg.debug_mode:
                raise
            log.exception(f'[Error] {e}')
            traceback.print_exc()
            result = {'errored': True}
        result.update({'dataset_name': dataset_name, 'seed': seed,
                       'method_name': method_name,
                       'domain_conf': domain_conf})
        log.info(f'[Exp evaluation complete] {result}')
        results.append(result)

    df = pd.DataFrame(results)
    from insite_tpu.harness.results import generate_main_results_table
    tables = generate_main_results_table(df)
    return df, tables


def _results_df_and_tables(results):
    import pandas as pd
    df = pd.DataFrame(results)
    if df.empty:
        return df, {}
    from insite_tpu.harness.results import generate_main_results_table
    return df, generate_main_results_table(df)


# (dataset, method) columns the vectorized paths cover (neural/ODE
# methods on device; msm as seed-batched host-f64 solves —
# harness/vectorized_msm.py)
VECTORIZED_METHODS = ('insite', 'sindy', 'wsindy', 'ct', 'crn', 'edct',
                      'rmsn', 'gnet', 'msm')


def _vectorized_confounding_sweep(cfg: RunConfig, log=logger):
    """INSIGHT_CONFOUNDING under --vectorized: the (gamma, seed) grid of
    each ODE method on EQ_4_D as one compiled program reused across
    gammas, logged as standard per-run rows (domain_conf column set per
    gamma, so the confounding figure and tables group correctly)."""
    from insite_tpu.harness.vectorized import vectorized_confounding_sweep
    results = []
    for method_name in cfg.methods:
        if method_name not in ('insite', 'sindy', 'wsindy'):
            log.warning(f'[vectorized] INSIGHT_CONFOUNDING has a '
                        f'vectorized path for the ODE methods only; '
                        f'skipping {method_name}')
            continue
        S = cfg.seed_runs
        thr, lam = sindy_params_for('EQ_4_D')
        log.info(f'[Now evaluating exp] (vectorized confounding, EQ_4_D, '
                 f'{method_name}, gammas={tuple(cfg.domain_confs)}, '
                 f'{S} seeds)')
        t0 = time.perf_counter()
        try:
            r = vectorized_confounding_sweep(
                'EQ_4_D', gammas=tuple(float(g) for g in cfg.domain_confs),
                n_seeds=S, n_train=cfg.train_samples,
                n_test=cfg.test_samples, method=method_name,
                threshold=thr, alpha=SINDY_ALPHA, lam=lam)
            secs = time.perf_counter() - t0
            n_rows = len(r['gammas']) * S
            for gi, gamma in enumerate(r['gammas']):
                for s in range(S):
                    row = {k: float(v[gi, s]) for k, v in r.items()
                           if isinstance(v, np.ndarray) and v.ndim == 2}
                    row.update({'method': method_name, 'seed': s,
                                'seconds_taken': secs / n_rows,
                                'vectorized': True, 'errored': False,
                                'dataset_name': 'EQ_4_D',
                                'method_name': method_name,
                                'domain_conf': float(gamma)})
                    log.info(f'[Exp evaluation complete] {row}')
                    results.append(row)
        except Exception as e:          # fault wall (run.py:159-169)
            if cfg.debug_mode:
                raise
            log.exception(f'[Error] {e}')
            traceback.print_exc()
            results.append({'errored': True, 'dataset_name': 'EQ_4_D',
                            'method_name': method_name, 'seed': -1,
                            'domain_conf': cfg.domain_conf})
    return _results_df_and_tables(results)


def _vectorized_grid_sweep(cfg: RunConfig, log=logger):
    """INSIGHT_NOISE (EQ_4_B x noise_scale grid) and INSIGHT_LESS_SAMPLES
    (EQ_4_D x train-cohort grid) as one vectorized 10-seed column per grid
    point — same row schema as the standard sweep (noise_scale /
    train_samples columns)."""
    from insite_tpu.harness.vectorized import vectorized_eq4_sweep
    noise_exp = cfg.experiment == 'INSIGHT_NOISE'
    dataset = 'EQ_4_B' if noise_exp else 'EQ_4_D'
    grid = cfg.noise_scales if noise_exp else cfg.train_sample_grid
    grid_key = 'noise_scale' if noise_exp else 'train_samples'
    results = []
    for method_name in cfg.methods:
        if method_name not in ('insite', 'sindy', 'wsindy'):
            log.warning(f'[vectorized] {cfg.experiment} has a vectorized '
                        f'path for the ODE methods only; skipping '
                        f'{method_name}')
            continue
        S = cfg.seed_runs
        thr, lam = sindy_params_for(dataset)
        for g in grid:
            log.info(f'[Now evaluating exp] (vectorized {cfg.experiment}, '
                     f'{dataset}, {method_name}, {grid_key}={g}, '
                     f'{S} seeds)')
            t0 = time.perf_counter()
            try:
                kw = dict(n_seeds=S, n_test=cfg.test_samples,
                          conf_coeff=cfg.domain_conf, threshold=thr,
                          alpha=SINDY_ALPHA, lam=lam, method=method_name)
                if noise_exp:
                    kw.update(n_train=cfg.train_samples,
                              noise_scale=float(g))
                else:
                    kw.update(n_train=int(g))
                r = vectorized_eq4_sweep(dataset, **kw)
                secs = time.perf_counter() - t0
                for s in range(S):
                    row = {k: float(v[s]) for k, v in r.items()
                           if isinstance(v, np.ndarray) and v.ndim == 1
                           and len(v) == S}
                    row.update({'method': method_name, 'seed': s,
                                'seconds_taken': secs / S,
                                'vectorized': True, 'errored': False,
                                'dataset_name': dataset,
                                'method_name': method_name,
                                'domain_conf': cfg.domain_conf,
                                grid_key: float(g)})
                    log.info(f'[Exp evaluation complete] {row}')
                    results.append(row)
            except Exception as e:      # fault wall (run.py:159-169)
                if cfg.debug_mode:
                    raise
                log.exception(f'[Error] {e}')
                traceback.print_exc()
                results.append({'errored': True, 'dataset_name': dataset,
                                'method_name': method_name, 'seed': -1,
                                'domain_conf': cfg.domain_conf,
                                grid_key: float(g)})
    return _results_df_and_tables(results)


class ColumnSkipped(Exception):
    """A (dataset, method) vectorized column has no applicable path (e.g.
    wsindy outside the EQ_4 family, matching the reference's skip at
    run.py:100-103)."""


def _vectorized_column(cfg: RunConfig, dataset_name: str, method_name: str,
                       log=logger):
    """Compute one (dataset, method) vectorized seed column.

    Returns ``(r, seeds)`` where ``r`` maps metric name -> np.ndarray [S]
    and ``seeds`` lists the seed of each entry.  Raises ColumnSkipped when
    the column has no vectorized path for this dataset.  Shared by the
    in-process sweep and the ``--isolate`` subprocess child
    (harness/isolated.py), so both execute the identical program.
    """
    S = cfg.seed_runs
    if method_name == 'msm':
        from insite_tpu.harness.vectorized_msm import vectorized_msm_sweep
        r = vectorized_msm_sweep(
            dataset_name, n_seeds=S,
            num_patients={'train': cfg.train_samples,
                          'val': cfg.val_samples,
                          'test': cfg.test_samples},
            coeff=cfg.domain_conf, epochs=cfg.epochs,
            seed_start=cfg.seed_start, cf_seq_mode=cfg.cf_seq_mode,
            noise_scale=cfg.noise_scale,
            model_overrides=_merged_overrides(
                cfg, method_name, dataset_name, cfg.domain_conf))
        return r, list(range(cfg.seed_start, cfg.seed_start + S))
    if method_name in ('ct', 'crn', 'edct', 'rmsn', 'gnet'):
        from insite_tpu.harness import vectorized_neural as vn
        kw = dict(
            n_seeds=S,
            num_patients={'train': cfg.train_samples,
                          'val': cfg.val_samples,
                          'test': cfg.test_samples},
            coeff=cfg.domain_conf, epochs=cfg.epochs,
            seed_start=cfg.seed_start,
            cf_seq_mode=cfg.cf_seq_mode,
            noise_scale=cfg.noise_scale,
            model_overrides=_merged_overrides(
                cfg, method_name, dataset_name, cfg.domain_conf))
        if method_name == 'ct':
            r = vn.vectorized_ct_sweep(dataset_name, **kw)
        elif method_name in ('crn', 'edct'):
            r = vn.vectorized_enc_dec_sweep(method_name, dataset_name, **kw)
        elif method_name == 'rmsn':
            r = vn.vectorized_rmsn_sweep(dataset_name, **kw)
        else:
            r = vn.vectorized_gnet_sweep(
                dataset_name, mc_samples=cfg.gnet_mc_samples, **kw)
        seeds = list(range(cfg.seed_start, cfg.seed_start + S))
    else:
        if method_name == 'wsindy' and 'EQ_4' not in dataset_name:
            raise ColumnSkipped(
                'wsindy runs on the EQ_4 family only (run.py:100-103); '
                f'skipping {dataset_name}')
        thr, lam = sindy_params_for(dataset_name)
        if cfg.seed_start:
            log.warning('[vectorized] ODE columns always run seeds '
                        '0..S-1 (PRNGKey-indexed); ignoring seed_start')
        if 'EQ_4' in dataset_name:
            from insite_tpu.harness.vectorized import vectorized_eq4_sweep
            r = vectorized_eq4_sweep(
                dataset_name, n_seeds=S, n_train=cfg.train_samples,
                n_test=cfg.test_samples, conf_coeff=cfg.domain_conf,
                threshold=thr, alpha=SINDY_ALPHA, lam=lam,
                method=method_name)
        else:
            from insite_tpu.harness.vectorized import vectorized_tumor_sweep
            r = vectorized_tumor_sweep(
                dataset_name, n_seeds=S, n_train=cfg.train_samples,
                n_test=cfg.test_samples, coeff=cfg.domain_conf,
                threshold=thr, alpha=SINDY_ALPHA, lam=lam,
                method=method_name)
        seeds = list(range(S))
    return r, seeds


def vectorized_sweep(cfg: RunConfig, log=logger):
    """`run.py --vectorized`: each (dataset, method) benchmark column runs
    as ONE on-device multi-seed dispatch (harness/vectorized[_neural] —
    the batched replacement for the reference's multiprocessing pool,
    run.py:91-131) and is logged as standard per-seed result rows, so
    `process_result_file.py` and `df_from_log` work unchanged.

    ODE columns use jax-native cohort sampling (distribution-level parity,
    seeds 0..S-1); the CT column keeps standard-path cohorts and honors
    `seed_start`. With `experiment=INSIGHT_CONFOUNDING` the whole
    (gamma, seed) grid runs via `vectorized_confounding_sweep` (one
    compiled program reused across gammas).

    With ``cfg.isolate_runs`` each column executes in a fresh interpreter
    (harness/isolated.py): a device-level failure — e.g. a device fault
    that would take every later column down with it — costs one column,
    not the rest of the sweep.
    """
    _log_fingerprint(cfg, cfg.experiment, log)
    if cfg.experiment == 'INSIGHT_CONFOUNDING':
        return _vectorized_confounding_sweep(cfg, log)
    if cfg.experiment in ('INSIGHT_NOISE', 'INSIGHT_LESS_SAMPLES'):
        return _vectorized_grid_sweep(cfg, log)
    results = []
    for dataset_name in cfg.datasets:
        for method_name in cfg.methods:
            if method_name not in VECTORIZED_METHODS:
                log.warning(f'[vectorized] no vectorized path for '
                            f'{method_name}; skipping (use the standard '
                            'sweep)')
                continue
            S = cfg.seed_runs
            log.info(f'[Now evaluating exp] (vectorized, {dataset_name}, '
                     f'{method_name}, {S} seeds)')
            t0 = time.perf_counter()
            try:
                if cfg.isolate_runs:
                    from insite_tpu.harness.isolated import \
                        run_isolated_column
                    r, seeds = run_isolated_column(dataset_name,
                                                   method_name, cfg)
                else:
                    r, seeds = _vectorized_column(cfg, dataset_name,
                                                  method_name, log)
                secs = time.perf_counter() - t0
                for i, seed in enumerate(seeds):
                    row = {k: float(v[i]) for k, v in r.items()
                           if isinstance(v, np.ndarray) and v.ndim == 1
                           and len(v) == S}
                    row.update({'method': method_name, 'seed': seed,
                                'seconds_taken': secs / S,
                                'vectorized': True, 'errored': False,
                                'dataset_name': dataset_name,
                                'method_name': method_name,
                                'domain_conf': cfg.domain_conf})
                    if method_name == 'rmsn':
                        ov = _merged_overrides(cfg, method_name,
                                               dataset_name,
                                               cfg.domain_conf)
                        row['sw_mode'] = (ov or {}).get('sw_mode',
                                                        'likelihood')
                    log.info(f'[Exp evaluation complete] {row}')
                    results.append(row)
            except ColumnSkipped as e:
                log.warning(f'[vectorized] {e}')
            except Exception as e:      # fault wall (run.py:159-169)
                if cfg.debug_mode:
                    raise
                log.exception(f'[Error] {e}')
                traceback.print_exc()
                results.append({'errored': True,
                                'dataset_name': dataset_name,
                                'method_name': method_name, 'seed': -1,
                                'domain_conf': cfg.domain_conf})

    return _results_df_and_tables(results)
