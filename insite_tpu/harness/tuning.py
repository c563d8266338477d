"""Hyperparameter tuning — batched re-expression of the reference's
Ray Tune + Optuna `finetune` path (time_varying_model.py:319-395 and the
`hparams_grid` YAMLs under config/backbone/*_hparams/).

Two tuners:

- `tune_insite_lam`: INSITE tunes exactly one hparam, the proximal penalty
  lam (insite_hparams_grid.yaml:8-16). Instead of Ray CPU actors we vmap the
  per-patient BFGS fine-tune over the whole lam grid — one XLA dispatch
  evaluates every grid point on the validation cohort simultaneously
  (lam is a traced scalar in `insite_finetune_predict`, so the grid axis
  costs zero recompiles).
- `grid_search`: generic seeded grid/random search for the neural baselines
  (the OptunaSearch analog), sequential trials with per-trial fault
  isolation (`max_failures` semantics, time_varying_model.py:383), selecting
  on validation factual RMSE ('val_rmse_all', the reference's
  `val_<crit>_all` metric).
"""

from __future__ import annotations

import itertools
import logging
import traceback

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger('insite_tpu')

# insite_hparams_grid.yaml:8-16
INSITE_LAM_GRID = (0.0, 10.0, 100.0, 200.0, 500.0, 1000.0, 2000.0)

# Neural search spaces distilled from the reference's Ray grids
# (config/backbone/<m>_hparams/cancer_sim_hparams_grid.yaml): learning
# rate / batch size / hidden widths / dropout. The reference expresses
# widths as input-size multipliers {0.5..4}; here they are absolute units
# spanning the same range around each model's benchmark defaults. Keys are
# this package's model-config fields (models/<m>.py), so the same dicts
# drive `model_overrides` and `grid_search`.
NEURAL_HPARAM_GRIDS = {
    'ct': {'learning_rate': [0.01, 0.001, 0.0001],
           'batch_size': [64, 128, 256],
           'seq_hidden_units': [8, 16, 32, 64],
           'br_size': [8, 16, 32, 64],
           'fc_hidden_units': [16, 32, 64, 128],
           'dropout_rate': [0.1, 0.2, 0.3, 0.4, 0.5]},
    'crn': {'enc_learning_rate': [0.01, 0.001, 0.0001],
            'enc_batch_size': [64, 128, 256],
            'enc_seq_hidden_units': [12, 24, 48, 96],
            'enc_br_size': [3, 6, 12, 24],
            'enc_fc_hidden_units': [9, 18, 36, 72],
            'enc_dropout_rate': [0.1, 0.2, 0.3, 0.4, 0.5],
            'dec_learning_rate': [0.01, 0.001, 0.0001],
            'dec_batch_size': [256, 512, 1024],
            'dec_dropout_rate': [0.1, 0.2, 0.3, 0.4, 0.5]},
    'edct': {'enc_learning_rate': [0.01, 0.001, 0.0001],
             'enc_batch_size': [64, 128, 256],
             'enc_seq_hidden_units': [8, 16, 32, 64],
             'enc_br_size': [8, 16, 32, 64],
             'enc_fc_hidden_units': [16, 32, 64, 128],
             'enc_dropout_rate': [0.1, 0.2, 0.3, 0.4, 0.5],
             'dec_learning_rate': [0.01, 0.001, 0.0001],
             'dec_batch_size': [256, 512, 1024],
             'dec_dropout_rate': [0.1, 0.2, 0.3, 0.4, 0.5]},
    'rmsn': {'enc_lr': [0.01, 0.001, 0.0001],
             'enc_bs': [64, 128, 256],
             'enc_hidden': [6, 12, 24, 48],
             'enc_dropout': [0.1, 0.2, 0.3, 0.4, 0.5],
             'dec_lr': [0.01, 0.001, 0.0001],
             'dec_hidden': [16, 32, 64, 128],
             'dec_dropout': [0.1, 0.2, 0.3, 0.4, 0.5]},
    'gnet': {'learning_rate': [0.01, 0.001, 0.0001],
             'batch_size': [64, 128, 256],
             'seq_hidden_units': [12, 24, 48, 96],
             'r_size': [3, 6, 12, 24],
             'fc_hidden_units': [24, 48, 96, 192],
             'dropout_rate': [0.1, 0.2, 0.3, 0.4, 0.5]},
}


def tune_insite_lam(model, val_f, lam_grid=INSITE_LAM_GRID,
                    projection_horizon=1):
    """Pick the proximal-penalty lam minimising validation factual RMSE.

    Every lam in the grid is evaluated in ONE jitted dispatch: the grid is a
    leading vmap axis over the per-patient BFGS fine-tune, so the device sees a
    (len(grid) * n_val_patients)-wide batch. Sets `model.cfg.lam` to the
    winner and returns (best_lam, {lam: rmse_all}).
    """
    from insite_tpu.eval.metrics import normalised_masked_rmse
    from insite_tpu.models.sindy import (insite_finetune_predict,
                                         insite_gn_finetune_predict)

    cfg = model.cfg
    prev, statics, arms, lengths = model._rollout_args(val_f)
    if cfg.smooth_input_data:
        from insite_tpu.discovery.differentiate import savgol_smooth
        prev = savgol_smooth(prev, lengths)
    coefs = jnp.asarray(model.coefs)
    grid = jnp.asarray(lam_grid, prev.dtype)
    # same clip + active-set as the prediction path (_fine_tune), so lam is
    # selected against the objective that will actually be used
    y_clip = model._y_clip()
    active_idx = tuple(
        int(i) for i in
        np.flatnonzero(np.abs(np.asarray(model.coefs)).reshape(-1) > 1e-3))

    def eval_lam(lam):
        if cfg.insite_solver == 'gauss_newton':
            return insite_gn_finetune_predict(
                model.library, coefs, prev, statics, arms, lengths,
                model.dt, lam, projection_horizon=projection_horizon,
                joint=cfg.joint_model, gn_iters=cfg.gn_iters,
                y_clip=y_clip, active_idx=active_idx)[0]
        return insite_finetune_predict(
            model.library, coefs, prev, statics, arms, lengths, model.dt,
            lam, projection_horizon=projection_horizon,
            joint=cfg.joint_model, bfgs_tol=cfg.bfgs_tol,
            bfgs_maxiter=cfg.bfgs_maxiter, y_clip=y_clip)[0]

    preds_g = jax.vmap(eval_lam)(grid)          # [G, B, T]
    sp = val_f.scaling_params
    preds_g = np.asarray(
        (preds_g - sp['output_means']) / sp['output_stds'])[..., None]

    scores = {}
    n = model._n_rows
    for lam, preds in zip(lam_grid, preds_g):
        _, rmse_all = normalised_masked_rmse(val_f, preds[:n])
        scores[float(lam)] = float(rmse_all)
    best = min(scores, key=scores.get)
    logger.info(f'[tune_insite_lam] grid scores (val rmse_all %): {scores} '
                f'-> lam={best}')
    model.cfg.lam = best
    return best, scores


def grid_points(space: dict, n_trials=None, seed=0):
    """Enumerate a hparams_grid dict (name -> list of values) into trial
    param dicts. With n_trials set, subsample the full product uniformly
    without replacement under a fixed seed (the OptunaSearch analog)."""
    names = sorted(space)
    full = [dict(zip(names, vals))
            for vals in itertools.product(*(space[n] for n in names))]
    if n_trials is None or n_trials >= len(full):
        return full
    rng = np.random.RandomState(seed)
    idx = rng.choice(len(full), size=n_trials, replace=False)
    return [full[i] for i in idx]


def successive_halving_search(build_and_fit, space: dict, val_f,
                              n_trials=16, seed=0, eta=3, min_budget=10,
                              max_budget=100, budget_key='epochs',
                              max_failures=3):
    """ADAPTIVE budgeted search — the reference's OptunaSearch-with-pruning
    analog (time_varying_model.py:339-384) without Ray: sample `n_trials`
    configs from the grid, fit each at a small `budget_key` budget, keep
    the top 1/eta by validation factual RMSE, multiply the budget by eta,
    repeat until `max_budget` — so most of the compute goes to configs
    that already proved themselves, unlike a flat grid.

    `build_and_fit(params)` receives the trial params WITH the current
    budget under `budget_key` (every neural model config has an `epochs`
    field). Returns (best_params, best_model, trials); best_model is
    trained at the full `max_budget`.
    """
    configs = grid_points(space, n_trials, seed)
    budget, rung, trials = min_budget, 0, []
    while True:
        scored = []
        for params in configs:
            p = {**params, budget_key: int(budget)}
            model, rmse = None, None
            for attempt in range(max_failures):
                try:
                    model = build_and_fit(dict(p))
                    _, rmse = model.get_normalised_masked_rmse(val_f)
                    break
                except Exception:
                    logger.warning(f'[sha] trial {p} attempt '
                                   f'{attempt + 1} failed:\n'
                                   f'{traceback.format_exc()}')
                    model, rmse = None, None
            trials.append({**p, 'rung': rung, 'val_rmse_all': rmse})
            logger.info(f'[sha] rung {rung} ({budget} {budget_key}) '
                        f'{params} -> val_rmse_all={rmse}')
            if rmse is not None:
                scored.append((rmse, params, model))
        if not scored:
            raise RuntimeError('successive_halving_search: every trial in '
                               f'rung {rung} errored')
        scored.sort(key=lambda t: t[0])
        if budget >= max_budget or len(scored) == 1:
            if budget < max_budget:      # lone survivor: refit at full
                p = {**scored[0][1], budget_key: int(max_budget)}
                model = build_and_fit(dict(p))
                _, rmse = model.get_normalised_masked_rmse(val_f)
                scored = [(rmse, scored[0][1], model)]
                trials.append({**p, 'rung': rung + 1,
                               'val_rmse_all': rmse})
            best = scored[0]
            logger.info(f'[sha] best {best[1]} '
                        f'(val_rmse_all={best[0]:.4f})')
            return dict(best[1]), best[2], trials
        keep = max(1, len(scored) // eta)
        configs = [p for _, p, _ in scored[:keep]]
        budget = min(max_budget, budget * eta)
        rung += 1


def grid_search(build_and_fit, space: dict, val_f, n_trials=None, seed=0,
                max_failures=3):
    """Sequential seeded search over `space`.

    `build_and_fit(params) -> estimator` must return a fitted
    CausalEstimator; selection metric is validation factual rmse_all.
    A trial that raises is retried up to `max_failures` times
    (time_varying_model.py:383), then recorded as errored. Returns
    (best_params, best_model, trials) where trials is a list of
    {**params, 'val_rmse_all': float | None}.
    """
    trials, best = [], (None, None, np.inf)
    for params in grid_points(space, n_trials, seed):
        model, rmse = None, None
        for attempt in range(max_failures):
            try:
                model = build_and_fit(dict(params))
                _, rmse = model.get_normalised_masked_rmse(val_f)
                break
            except Exception:
                logger.warning(f'[grid_search] trial {params} attempt '
                               f'{attempt + 1} failed:\n'
                               f'{traceback.format_exc()}')
                model, rmse = None, None
        trials.append({**params, 'val_rmse_all': rmse})
        logger.info(f'[grid_search] {params} -> val_rmse_all={rmse}')
        if rmse is not None and rmse < best[2]:
            best = (dict(params), model, rmse)
    if best[0] is None:
        raise RuntimeError('grid_search: every trial errored')
    logger.info(f'[grid_search] best {best[0]} (val_rmse_all={best[2]:.4f})')
    return best[0], best[1], trials
