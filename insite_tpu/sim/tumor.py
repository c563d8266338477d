"""Tumor-growth simulator core (Geng et al. 2017) — shared by the
"cancer_sim" benchmark and the "continuous" EQ_5 A-D family.

Batched array re-design of the reference NumPy/python-loop simulators
(/root/reference/libs_m/ct/src/data/cancer_sim/cancer_simulation.py and
continuous/continuous.py).  Discrete update per day
(cancer_simulation.py:300-302):

    V[t] = V[t-1] * (1 + rho*log(K/V[t-1]) - beta_c*C[t-1]
                     - (alpha*d[t-1] + beta*d[t-1]^2) + eps[t])

with chemo concentration C decaying with a 1-day half life plus applied dose,
radio dose d in {0, 2}, and sigmoid-confounded treatment assignment on the
15-day mean tumour diameter.  The python `for t ... break` loops become one
`lax.scan` over time carrying the whole cohort: an `alive` mask reproduces
the death/recovery early exit, and a fixed-width rolling buffer implements
the mean-diameter window.  Counterfactual branches (one-step and
projection-horizon plans) are evaluated for *all* prefixes and plans as
broadcasted tensors after the factual scan — no per-patient loops anywhere.

Deliberate deviation, documented: the reference's counterfactual generators
index the treatment-assignment window into the half-filled *output row
buffer* instead of the patient's own trajectory
(cancer_simulation.py:471,671 — `cancer_volume[i, ...]` where `i` is a
patient index into a test-row array), i.e. the confounding window reads
whatever earlier test row happened to live there.  We implement the
documented intent (window over the patient's own factual history); the
test-set treatment distribution differs slightly from the shipped logs but
is identical for every method evaluated on it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


TUMOUR_CELL_DENSITY = 5.8e8
CHEMO_AMT = 5.0
RADIO_AMT = 2.0
DRUG_DECAY = float(np.exp(-np.log(2.0) / 1.0))   # 1-day half-life


def calc_volume(diameter):
    return 4.0 / 3.0 * np.pi * (diameter / 2.0) ** 3


def calc_diameter(volume):
    return ((volume / (4.0 / 3.0 * np.pi)) ** (1.0 / 3.0)) * 2.0


TUMOUR_DEATH_THRESHOLD = calc_volume(13.0)


def _diameter(volume):
    return ((volume / (4.0 / 3.0 * jnp.pi)) ** (1.0 / 3.0)) * 2.0


def _window_mean_diameter(buf, count, lag: int = 0):
    """Mean diameter over ``count`` buffer entries ending ``lag`` slots
    before the buffer end (most recent last) — the reference window
    volumes[max(t-w-lag, 0) : t-lag] (cancer_simulation.py:308-314).
    count is a traced scalar; zero count -> diameter of a zero volume
    (the reference's `np.zeros((1,))` fallback)."""
    W = buf.shape[-1]
    pos = jnp.arange(W)
    pos_ok = (pos >= (W - lag - count)) & (pos < W - lag)
    diam = _diameter(buf)
    total = jnp.sum(jnp.where(pos_ok[None, :], diam, 0.0), axis=-1)
    return jnp.where(count > 0, total / jnp.maximum(count, 1), 0.0)


def _volume_update(v, chemo, radio, alpha, beta, beta_c, rho, K, eps,
                   guard=0.0):
    # max(v, tiny) keeps masked (dead/recovered, v=0) lanes finite; active
    # lanes are never that small, so the dynamics are unchanged
    v_safe = jnp.maximum(v + guard, 1e-30)
    growth = rho * jnp.log(K / v_safe + guard)
    return v * (1.0 + growth - beta_c * chemo -
                (alpha * radio + beta * radio * radio) + eps)


def _assign(probs_rv, metric, sig_beta, sig_intercept):
    prob = 1.0 / (1.0 + jnp.exp(-sig_beta * (metric - sig_intercept)))
    return (probs_rv < prob), prob


# ---------------------------------------------------------------------------
# factual cohort scan  (cancer_simulation.py:218-375)

@partial(jax.jit, static_argnums=(2, 3, 4))
def factual_core(params, rvs, seq_length: int, window_size: int, lag: int):
    """rvs: dict with noise [B,T], recovery [B,T], chemo_rv [B,T],
    radio_rv [B,T].  Returns the full trajectory arrays + sequence lengths +
    death/recovery flags."""
    dtype = rvs['noise'].dtype
    v0 = params['initial_volumes'].astype(dtype)
    B = v0.shape[0]
    thr = jnp.asarray(TUMOUR_DEATH_THRESHOLD, dtype)

    alpha, beta = params['alpha'].astype(dtype), params['beta'].astype(dtype)
    beta_c, rho = params['beta_c'].astype(dtype), params['rho'].astype(dtype)
    K = params['K'].astype(dtype)
    c_beta = params['chemo_sigmoid_betas'].astype(dtype)
    c_int = params['chemo_sigmoid_intercepts'].astype(dtype)
    r_beta = params['radio_sigmoid_betas'].astype(dtype)
    r_int = params['radio_sigmoid_intercepts'].astype(dtype)

    buf0 = jnp.zeros((B, window_size + lag), dtype).at[:, -1].set(v0)

    def step(carry, xs):
        v_prev, chemo_prev, radio_prev, alive, buf = carry
        t, eps, rec_rv, chemo_rv, radio_rv = xs

        v_t = _volume_update(v_prev, chemo_prev, radio_prev, alpha, beta,
                             beta_c, rho, K, eps)

        # window over volumes [max(t-w-lag,0), t-lag): excludes v_t and the
        # lag most recent entries (cancer_simulation.py:308-314); buffer
        # holds ..., v_{t-1}
        count = jnp.minimum(t - lag, window_size) * (t >= lag)
        metric = _window_mean_diameter(buf, count, lag)
        chemo_app, chemo_p = _assign(chemo_rv, metric, c_beta, c_int)
        radio_app, radio_p = _assign(radio_rv, metric, r_beta, r_int)
        radio_dose = jnp.where(radio_app, RADIO_AMT, 0.0).astype(dtype)
        chemo_dose = chemo_prev * DRUG_DECAY + \
            jnp.where(chemo_app, CHEMO_AMT, 0.0)

        died = v_t > thr
        v_t = jnp.where(died, thr, v_t)
        recovered = (~died) & (rec_rv < jnp.exp(-v_t * TUMOUR_CELL_DENSITY))
        v_t = jnp.where(recovered, 0.0, v_t)

        def live(x):
            return jnp.where(alive, x, 0.0)
        v_rec = live(v_t)
        out = (v_rec, live(chemo_dose), live(radio_dose),
               live(chemo_app.astype(dtype)), live(radio_app.astype(dtype)),
               live(chemo_p), live(radio_p),
               (died & alive), (recovered & alive))

        stop = died | recovered
        alive_next = alive & ~stop
        buf = jnp.concatenate([buf[:, 1:], v_rec[:, None]], axis=1)
        return (v_rec, live(chemo_dose), live(radio_dose),
                alive_next, buf), out

    ts = jnp.arange(1, seq_length - 1)
    xs = (ts, rvs['noise'][:, 1:seq_length - 1].T,
          rvs['recovery'][:, 1:seq_length - 1].T,
          rvs['chemo_rv'][:, 1:seq_length - 1].T,
          rvs['radio_rv'][:, 1:seq_length - 1].T)
    init = (v0, jnp.zeros(B, dtype), jnp.zeros(B, dtype),
            jnp.ones(B, bool), buf0)
    _, outs = lax.scan(step, init, xs)
    (v_seq, cd_seq, rd_seq, ca_seq, ra_seq, cp_seq, rp_seq,
     died_seq, rec_seq) = [jnp.moveaxis(o, 0, 1) for o in outs]

    pad = jnp.zeros((B, 1), dtype)
    volumes = jnp.concatenate([v0[:, None], v_seq, pad], axis=1)
    chemo_dosage = jnp.concatenate([pad, cd_seq, pad], axis=1)
    radio_dosage = jnp.concatenate([pad, rd_seq, pad], axis=1)
    chemo_app = jnp.concatenate([pad, ca_seq, pad], axis=1)
    radio_app = jnp.concatenate([pad, ra_seq, pad], axis=1)
    chemo_probs = jnp.concatenate([pad, cp_seq, pad], axis=1)
    radio_probs = jnp.concatenate([pad, rp_seq, pad], axis=1)

    stopped = died_seq | rec_seq                          # [B, T-2]
    any_stop = jnp.any(stopped, axis=1)
    stop_t = jnp.argmax(stopped, axis=1) + 1              # actual t index
    seq_lengths = jnp.where(any_stop, stop_t + 1, seq_length - 1)
    death_flags = jnp.zeros((B, seq_length), dtype)
    death_flags = death_flags.at[jnp.arange(B), stop_t].set(
        jnp.any(died_seq, axis=1).astype(dtype) * any_stop)
    recovery_flags = jnp.zeros((B, seq_length), dtype)
    recovery_flags = recovery_flags.at[jnp.arange(B), stop_t].set(
        jnp.any(rec_seq, axis=1).astype(dtype) * any_stop)

    return dict(cancer_volume=volumes, chemo_dosage=chemo_dosage,
                radio_dosage=radio_dosage, chemo_application=chemo_app,
                radio_application=radio_app,
                chemo_probabilities=chemo_probs,
                radio_probabilities=radio_probs,
                sequence_lengths=seq_lengths, death_flags=death_flags,
                recovery_flags=recovery_flags)


# ---------------------------------------------------------------------------
# counterfactual factual-branch scan (shared by 1-step and seq generators;
# cancer_simulation.py:463-552 — loop starts at t=0, volumes are clipped)

@partial(jax.jit, static_argnums=(2, 3, 4))
def cf_factual_core(params, rvs, seq_length: int, window_size: int,
                    lag: int):
    """Returns per-step arrays of the counterfactual generators' factual
    branch: volumes [B, T] (V[t+1] emitted at step t, clipped), dosages /
    applications at t, and `active` [B, T-1] marking steps the reference
    loop actually processed (break happens *after* emitting rows)."""
    dtype = rvs['noise'].dtype
    v0 = params['initial_volumes'].astype(dtype)
    B = v0.shape[0]
    thr = jnp.asarray(TUMOUR_DEATH_THRESHOLD, dtype)

    alpha, beta = params['alpha'].astype(dtype), params['beta'].astype(dtype)
    beta_c, rho = params['beta_c'].astype(dtype), params['rho'].astype(dtype)
    K = params['K'].astype(dtype)
    c_beta = params['chemo_sigmoid_betas'].astype(dtype)
    c_int = params['chemo_sigmoid_intercepts'].astype(dtype)
    r_beta = params['radio_sigmoid_betas'].astype(dtype)
    r_int = params['radio_sigmoid_intercepts'].astype(dtype)

    buf0 = jnp.zeros((B, window_size + 1 + lag), dtype)

    def step(carry, xs):
        v_t, chemo_prev, active, buf = carry
        t, eps_next, rec_rv, chemo_rv, radio_rv = xs

        # window [max(t-w-lag,0), t-lag+1): *includes* v_{t-lag}, so up to
        # window_size+1 entries (cancer_simulation.py:471) — push v_t first
        buf = jnp.concatenate([buf[:, 1:], v_t[:, None]], axis=1)
        count = jnp.minimum(t - lag + 1, window_size + 1) * (t >= lag)
        metric = _window_mean_diameter(buf, count, lag)
        chemo_app, _ = _assign(chemo_rv, metric, c_beta, c_int)
        radio_app, _ = _assign(radio_rv, metric, r_beta, r_int)
        radio_dose = jnp.where(radio_app, RADIO_AMT, 0.0).astype(dtype)
        chemo_dose = chemo_prev * DRUG_DECAY + \
            jnp.where(chemo_app, CHEMO_AMT, 0.0)

        v_next = _volume_update(v_t, chemo_dose, radio_dose, alpha, beta,
                                beta_c, rho, K, eps_next)
        v_next = jnp.clip(v_next, 0.0, thr)

        stop = (v_next >= thr) | \
            (rec_rv <= jnp.exp(-v_next * TUMOUR_CELL_DENSITY))

        def live(x):
            return jnp.where(active, x, 0.0)
        out = (live(v_next), live(chemo_dose), live(radio_dose),
               live(chemo_app.astype(dtype)), live(radio_app.astype(dtype)),
               active)
        active_next = active & ~stop
        return (live(v_next), live(chemo_dose), active_next, buf), out

    ts = jnp.arange(0, seq_length - 1)
    xs = (ts, rvs['noise'][:, 1:seq_length].T,
          rvs['recovery'][:, :seq_length - 1].T,
          rvs['chemo_rv'][:, :seq_length - 1].T,
          rvs['radio_rv'][:, :seq_length - 1].T)
    init = (v0, jnp.zeros(B, dtype), jnp.ones(B, bool), buf0)
    _, outs = lax.scan(step, init, xs)
    v_seq, cd_seq, rd_seq, ca_seq, ra_seq, act_seq = \
        [jnp.moveaxis(o, 0, 1) for o in outs]

    volumes = jnp.concatenate([v0[:, None], v_seq], axis=1)   # [B, T]
    return dict(volumes=volumes, chemo_dosage=cd_seq, radio_dosage=rd_seq,
                chemo_application=ca_seq, radio_application=ra_seq,
                active=act_seq)


# ---------------------------------------------------------------------------
# counterfactual row construction (vectorised analogues of the reference's
# test_idx append loops, cancer_simulation.py:434-563 and :632-773)

@partial(jax.jit, static_argnums=(3,))
def cf_one_step_rows(params, fact: dict, noise, seq_length: int):
    """All (patient, prefix t, 4 treatment options) rows at once.

    Row for the factual option carries the clipped factual next volume; the
    three others carry the unclipped one-step counterfactual — exactly the
    4 rows the reference emits per processed step (factual row + 3 options,
    cancer_simulation.py:504-548).  Returns
    (volumes [B, T-1, 4, T], chemo_app, radio_app [B, T-1, 4, T],
     seq_lengths [B, T-1, 4], valid [B, T-1, 4])."""
    dtype = fact['volumes'].dtype
    volumes = fact['volumes']                   # [B, T]
    B, T = volumes.shape
    thr = jnp.asarray(TUMOUR_DEATH_THRESHOLD, dtype)

    alpha = params['alpha'].astype(dtype)[:, None]
    beta = params['beta'].astype(dtype)[:, None]
    beta_c = params['beta_c'].astype(dtype)[:, None]
    rho = params['rho'].astype(dtype)[:, None]
    K = params['K'].astype(dtype)[:, None]

    prev_chemo = jnp.concatenate(
        [jnp.zeros((B, 1), dtype), fact['chemo_dosage'][:, :-1]], axis=1)

    # option axis: (chemo, radio) in [(0,0),(0,1),(1,0),(1,1)] order
    opt_c = jnp.asarray([0., 0., 1., 1.], dtype)
    opt_r = jnp.asarray([0., 1., 0., 1.], dtype)
    dose_c = prev_chemo[:, :, None] * DRUG_DECAY + CHEMO_AMT * opt_c
    dose_r = RADIO_AMT * opt_r + jnp.zeros_like(dose_c)
    v_cf = _volume_update(volumes[:, :-1, None], dose_c, dose_r,
                          alpha[..., None], beta[..., None],
                          beta_c[..., None], rho[..., None], K[..., None],
                          noise[:, 1:T, None])            # [B, T-1, 4]

    is_factual = (fact['chemo_application'][:, :, None] == opt_c) & \
                 (fact['radio_application'][:, :, None] == opt_r)
    last_val = jnp.where(is_factual, volumes[:, 1:, None], v_cf)

    t_grid = jnp.arange(T - 1)[:, None]
    j_grid = jnp.arange(T)[None, :]
    in_prefix = (j_grid <= t_grid)[None, :, None, :]      # j <= t
    at_next = (j_grid == t_grid + 1)[None, :, None, :]
    vol_rows = jnp.where(in_prefix, volumes[:, None, None, :], 0.0)
    vol_rows = jnp.where(at_next, last_val[..., None], vol_rows)

    def app_rows(app_seq, opt):
        pad_app = jnp.pad(app_seq, ((0, 0), (0, 1)))      # width T
        rows = jnp.where((j_grid < t_grid)[None, :, None, :],
                         pad_app[:, None, None, :], 0.0)
        rows = jnp.where((j_grid == t_grid)[None, :, None, :],
                         opt[None, None, :, None] + jnp.zeros_like(rows),
                         rows)
        return rows

    chemo_rows = app_rows(fact['chemo_application'], opt_c)
    radio_rows = app_rows(fact['radio_application'], opt_r)

    seq_lengths = jnp.broadcast_to((t_grid[:, 0] + 1)[None, :, None],
                                   (B, T - 1, 4))
    valid = jnp.broadcast_to(fact['active'][:, :, None], (B, T - 1, 4))
    return vol_rows, chemo_rows, radio_rows, seq_lengths, valid


@partial(jax.jit, static_argnums=(4, 5))
def cf_seq_rows(params, fact: dict, plans, noise, seq_length: int, ph: int):
    """All (patient, prefix t, plan p) projection-horizon rows.

    plans: [B, T-1, P, ph, 2] binary (chemo, radio) plans.  Each plan rolls
    ``ph`` tumour-update steps from the factual state V[t+1] with the chemo
    concentration chain continuing from the factual dosage at t
    (cancer_simulation.py:707-756).  Returns volumes [B, T-1, P, T+ph],
    chemo_app/radio_app/chemo_dosage rows, seq_lengths, valid."""
    dtype = fact['volumes'].dtype
    volumes = fact['volumes']
    B, T = volumes.shape
    P = plans.shape[2]

    def pexp(x):
        return x.astype(dtype)[:, None, None]

    alpha, beta = pexp(params['alpha']), pexp(params['beta'])
    beta_c, rho = pexp(params['beta_c']), pexp(params['rho'])
    K = pexp(params['K'])

    plans = plans.astype(dtype)
    v = jnp.broadcast_to(volumes[:, 1:T, None], (B, T - 1, P))
    chemo_prev = jnp.broadcast_to(fact['chemo_dosage'][:, :, None],
                                  (B, T - 1, P))
    t_idx = jnp.arange(T - 1)
    cf_vols, cf_doses = [], []
    for pt in range(ph):
        dose_c = chemo_prev * DRUG_DECAY + CHEMO_AMT * plans[..., pt, 0]
        dose_r = RADIO_AMT * plans[..., pt, 1]
        eps = noise[:, t_idx + 2 + pt][:, :, None]   # noise[current_t + 1]
        v = _volume_update(v, dose_c, dose_r, alpha, beta, beta_c, rho, K,
                           eps, guard=1e-7)
        cf_vols.append(v)
        cf_doses.append(dose_c)
        chemo_prev = dose_c
    cf_vols = jnp.stack(cf_vols, axis=-1)              # [B, T-1, P, ph]
    cf_doses = jnp.stack(cf_doses, axis=-1)

    T_out = T + ph
    t_grid = jnp.arange(T - 1)[:, None]
    j_grid = jnp.arange(T_out)[None, :]
    pad_vol = jnp.pad(volumes, ((0, 0), (0, ph)))
    base = jnp.where((j_grid <= t_grid + 1)[None, :, None, :],
                     pad_vol[:, None, None, :], 0.0)
    k = j_grid - (t_grid + 2)
    k_clip = jnp.clip(k, 0, ph - 1)
    cf_part = jnp.take_along_axis(
        cf_vols, jnp.broadcast_to(k_clip[None, :, None, :],
                                  (B, T - 1, P, T_out)), axis=-1)
    in_cf = ((k >= 0) & (k < ph))[None, :, None, :]
    vol_rows = jnp.where(in_cf, cf_part, base)

    ka = j_grid - (t_grid + 1)
    ka_clip = jnp.clip(ka, 0, ph - 1)
    in_plan = ((ka >= 0) & (ka < ph))[None, :, None, :]

    def assemble(fact_seq, plan_vals):
        pad_f = jnp.pad(fact_seq, ((0, 0), (0, T_out - fact_seq.shape[1])))
        rows = jnp.where((j_grid <= t_grid)[None, :, None, :],
                         pad_f[:, None, None, :], 0.0)
        part = jnp.take_along_axis(
            plan_vals, jnp.broadcast_to(ka_clip[None, :, None, :],
                                        (B, T - 1, P, T_out)), axis=-1)
        return jnp.where(in_plan, part, rows)

    chemo_rows = assemble(fact['chemo_application'], plans[..., 0])
    radio_rows = assemble(fact['radio_application'], plans[..., 1])
    dose_rows = assemble(fact['chemo_dosage'], cf_doses)

    seq_lengths = jnp.broadcast_to((t_grid[:, 0] + 1 + ph)[None, :, None],
                                   (B, T - 1, P))
    valid = jnp.broadcast_to(fact['active'][:, :, None], (B, T - 1, P))
    valid = valid & ~jnp.any(jnp.isnan(vol_rows), axis=-1)
    # The reference drops any row whose cf trajectory contains NaN
    # (cancer_simulation.py:745-746): with its log guard
    # log(K/(V+1e-7)+1e-7), a volume V <= -1e-7 at any *non-final* plan
    # step NaNs the next update (a negative final value is kept — nothing
    # consumes it).  Our _volume_update keeps negative volumes finite
    # (v_safe floor), so reproduce the drop explicitly: extreme patients
    # (huge alpha) otherwise leave exploding negative "ground truth" in
    # the test set.
    if ph > 1:
        neg_mid = jnp.any(cf_vols[..., :ph - 1] + 1e-7 <= 0.0, axis=-1)
        valid = valid & ~neg_mid
    return vol_rows, chemo_rows, radio_rows, dose_rows, seq_lengths, valid
