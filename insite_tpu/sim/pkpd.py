"""PKPD "EQ_4" simulator — one-compartment exponential-decay pharmacology
model with time-dependent confounded treatment assignment.

Batched array re-design of the reference simulator
(/root/reference/libs_m/ct/src/data/pkpd/pkpd_simulation.py).  The ground
truth dynamics are ``dy/dt = -C_a * y`` with the decay constant ``C_a``
switched by the (per-patient, time-constant) treatment arm
(pkpd_simulation.py:69-74).  Because the Euler discretisation of a linear
homogeneous ODE is a per-interval multiplicative factor, the *entire*
simulator — factual rollouts, all one-step counterfactuals and every
projection-horizon counterfactual plan — collapses into batched cumulative
products over ``[B, T]``/``[B, T, plans, horizon]`` arrays: no per-patient
Python loops, no `vmap` of scalar integrators, no sequential counterfactual
scans.  One XLA program simulates the whole cohort.

Semantics intentionally preserved from the reference (same distributions,
same jax.random split order so that f64 CPU runs reproduce the reference
datasets, same truncation rules, same padded test-set row layout):

- parameter generation variants A-D, M   (pkpd_simulation.py:96-203)
- sigmoid confounded treatment assignment (pkpd_simulation.py:253-259)
- recovery/death truncation               (pkpd_simulation.py:238-268)
- observation noise for variants B/C/D    (pkpd_simulation.py:289-291)
- 1-step counterfactual row explosion     (pkpd_simulation.py:352-471)
- sliding/random treatment-sequence counterfactuals
                                          (pkpd_simulation.py:474-667)
"""

from __future__ import annotations

from enum import IntEnum
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax, random

from insite_tpu.core.constants import (
    MAX_TIME_HORIZON,
    MAX_VALUE,
    OBSERVATION_NOISE,
    RECOVERY_MULTIPLIER,
    STEPS_FOR_DT,
)
from insite_tpu.core.dtypes import default_float


class Equation(IntEnum):
    EQ_4_A = 1
    EQ_4_B = 2
    EQ_4_C = 3
    EQ_4_D = 4
    EQ_5_A = 5
    EQ_5_B = 6
    EQ_5_C = 7
    EQ_5_D = 8
    EQ_4_M = 9


class CfSeqMode(IntEnum):
    SLIDING_TREATMENT = 1
    RANDOM_TRAJECTORIES = 2


def true_dy_dt(y, t, treatment, hidden_c0, hidden_c1):
    """Ground-truth vector field (pkpd_simulation.py:69-74), batched: all
    arguments broadcast."""
    c = jnp.where(treatment == 0, hidden_c0, hidden_c1)
    return -c * y


def _substeps_for(seq_length: int) -> int:
    """Reference odeint integrates with STEPS_FOR_DT sub-steps only when
    dt > HMAX (utils.py:87-90); for seq_length >= 300 the interval is
    already finer than HMAX and a single Euler step is used."""
    from insite_tpu.core.constants import HMAX
    dt = MAX_TIME_HORIZON / seq_length
    return STEPS_FOR_DT if dt > HMAX else 1


def _decay_factor(c, dt, substeps: int = STEPS_FOR_DT):
    """Euler-discretised per-interval decay factor: the exact multiplier that
    ``substeps`` Euler sub-steps of ``dy/dt=-c*y`` apply over one interval."""
    h = dt / substeps
    y = jnp.ones_like(c)
    for _ in range(substeps):
        y = y + (-c * y) * h
    return y


# ---------------------------------------------------------------------------
# Parameter generation (pkpd_simulation.py:76-203)

def generate_params(num_patients: int, conf_coeff: float, window_size: int,
                    lag: int, key, equation: Equation,
                    dtype=None) -> dict:
    dtype = dtype or default_float()
    params = _get_standard_params_jit(key, num_patients, equation.name,
                                      dtype=dtype)
    params = dict(params)
    params['observation_noise'] = OBSERVATION_NOISE
    params['sigmoid_intercept'] = MAX_VALUE / 2.0
    params['sigmoid_gamma'] = conf_coeff / MAX_VALUE
    params['window_size'] = window_size
    params['lag'] = lag
    return params


@partial(jax.jit, static_argnums=(1, 2), static_argnames=('dtype',))
def _get_standard_params_jit(key, num_patients: int, equation_name: str,
                             dtype=jnp.float32):
    params = get_standard_params(num_patients, Equation[equation_name], key,
                                 dtype=dtype)
    params.pop('observation_noise')
    return params


def get_standard_params(num_patients: int, equation: Equation, key,
                        dtype=None) -> dict:
    """Patient-specific constants for variants A (clean), B (+obs noise),
    C (params linear in observed statics), D (C + shared param noise),
    M (multimodal).  Split order matches pkpd_simulation.py:96-203."""
    dtype = dtype or default_float()
    scale = 0.5
    sigma_0 = 0.1 * scale
    sigma_1 = 0.1 * scale
    c_0_mean = 1.0 * scale
    c_1_mean = 1.0 * scale

    key, sub = random.split(key)
    c_0 = random.normal(sub, (num_patients,), dtype) * sigma_0 + c_0_mean
    key, sub = random.split(key)
    c_1 = random.normal(sub, (num_patients,), dtype) * sigma_1 + c_1_mean

    C_0, C_1 = c_0, c_1
    name = equation.name
    if name in ('EQ_4_C', 'EQ_4_D'):
        # fixed linear dependence on the observed statics
        # (theta values of pkpd_simulation.py:137-149)
        C_0 = 1.0 * c_0 + 0.1 * scale
        C_1 = 1.0 * c_1 + 0.3 * scale
        if name == 'EQ_4_D':
            sigma_c = 0.5 * scale
            key, sub = random.split(key)
            C_0 = random.normal(sub, dtype=dtype) * sigma_c + C_0
            key, sub = random.split(key)
            C_1 = random.normal(sub, dtype=dtype) * sigma_c + C_1
    elif name == 'EQ_4_M':
        modes = jnp.array([0.1, 0.3], dtype) * scale
        key, sub = random.split(key)
        C_0 = c_0 + random.choice(sub, modes, shape=(num_patients,))
        key, sub = random.split(key)
        C_1 = c_1 + random.choice(sub, modes, shape=(num_patients,))
    elif 'EQ_5' in name:
        raise NotImplementedError('EQ_5 lives in insite_tpu.sim.continuous')

    key, sub = random.split(key)
    initial_volumes = random.uniform(sub, (num_patients,), dtype,
                                     minval=1.0, maxval=MAX_VALUE)

    holder = {
        'initial_volumes': initial_volumes,
        'hidden_C_0': C_0,
        'hidden_C_1': C_1,
        'observed_static_c_0': c_0,
        'observed_static_c_1': c_1,
    }
    key, sub = random.split(key)
    idx = random.permutation(sub, jnp.arange(num_patients), independent=True)
    params = {k: v[idx] for k, v in holder.items()}
    params['observation_noise'] = OBSERVATION_NOISE
    return params


# ---------------------------------------------------------------------------
# Shared pieces

def _treatment_from_rv(params, rv):
    """Confounded biased coin per patient: p = sigma(gamma/MAX*(y0 - MAX/2))
    (pkpd_simulation.py:255-259)."""
    y0 = params['initial_volumes']
    prob = 1.0 / (1.0 + jnp.exp(-params['sigmoid_gamma'] *
                                (y0 - params['sigmoid_intercept'])))
    return (rv < prob).astype(jnp.int32)


def _factual_volumes(params, treatment, n_steps, dtype, dt,
                     substeps: int = STEPS_FOR_DT):
    """Closed-form batched factual rollout: ``[B, n_steps+1]`` volumes."""
    dt = jnp.asarray(dt, dtype)
    c = jnp.where(treatment == 1, params['hidden_C_1'], params['hidden_C_0'])
    f = _decay_factor(c.astype(dtype), dt, substeps)             # [B]
    steps = jnp.broadcast_to(f[:, None], (f.shape[0], n_steps))  # [B, T]
    cum = jnp.cumprod(steps, axis=1)
    v0 = params['initial_volumes'].astype(dtype)
    return jnp.concatenate([v0[:, None], v0[:, None] * cum], axis=1)


def _add_observation_noise_always(volumes, params, key):
    key, sub = random.split(key)
    return volumes + params['observation_noise'] * \
        random.normal(sub, volumes.shape, volumes.dtype)


# ---------------------------------------------------------------------------
# Factual simulation (pkpd_simulation.py:205-309)

@partial(jax.jit, static_argnums=(2, 3), static_argnames=('dtype',))
def _simulate_factual_full(params, key, seq_length: int, add_noise: bool,
                           dtype=jnp.float32):
    """Single-dispatch factual simulation: RNG draws + rollout + truncation
    + observation noise fused into one XLA program instead of one dispatch
    per draw)."""
    num_patients = params['initial_volumes'].shape[0]
    key, sub = random.split(key)
    recovery_rvs = random.uniform(sub, (num_patients, seq_length), dtype)
    key, sub = random.split(key)
    treatment_rvs = random.uniform(sub, (num_patients,), dtype)
    volumes, treatments, seq_lengths = _simulate_factual_core(
        params, treatment_rvs, recovery_rvs, seq_length, dtype=dtype)
    if add_noise:
        volumes = _add_observation_noise_always(volumes, params, key)
    return volumes, treatments, seq_lengths


def simulate_factual(params, seq_length: int, key, equation: Equation,
                     dtype=None) -> dict:
    dtype = dtype or default_float()
    add_noise = equation.name.split('_')[-1] in ('B', 'C', 'D')
    volumes, treatments, seq_lengths = _simulate_factual_full(
        params, key, seq_length, add_noise, dtype=dtype)
    # one batched async fetch instead of serial synchronous per-array
    # pulls (np.asarray); device_get prefetches
    (volumes, treatments, seq_lengths, statics0, statics1) = jax.device_get(
        (volumes, treatments, seq_lengths,
         params['observed_static_c_0'], params['observed_static_c_1']))
    out = {
        'cancer_volume': volumes,
        'treatment_application': treatments,
        'sequence_lengths': seq_lengths,
        'observed_static_c_0': statics0,
        'observed_static_c_1': statics1,
    }
    assert not np.any(np.isnan(out['cancer_volume']))
    return out


@partial(jax.jit, static_argnums=(3,), static_argnames=('dtype',))
def _simulate_factual_core(params, treatment_rvs, recovery_rvs,
                           seq_length: int, dtype=jnp.float64):
    treatment = _treatment_from_rv(params, treatment_rvs)            # [B]
    volumes = _factual_volumes(params, treatment, seq_length - 1, dtype,
                               MAX_TIME_HORIZON / seq_length,
                               _substeps_for(seq_length))

    B, T = volumes.shape
    idx = jnp.arange(T)

    # Recovery truncation: zero from the first step whose recovery draw fires
    # (pkpd_simulation.py:238-243).
    recovery_cond = recovery_rvs < jnp.exp(-volumes * RECOVERY_MULTIPLIER)
    any_rec = jnp.any(recovery_cond, axis=1)
    rec_idx = jnp.argmax(recovery_cond, axis=1)
    seq_lengths = jnp.where(any_rec, rec_idx + 1, seq_length - 1)
    volumes = jnp.where(any_rec[:, None] & (idx[None, :] >= rec_idx[:, None]),
                        0.0, volumes)

    # Death truncation: clamp to MAX_VALUE from the first exceedance
    # (pkpd_simulation.py:245-250); applied after recovery, taking that
    # branch's sequence length if it fires (lax.cond chain in :265-268).
    death_cond = volumes > MAX_VALUE
    any_death = jnp.any(death_cond, axis=1)
    death_idx = jnp.argmax(death_cond, axis=1)
    seq_lengths = jnp.where(any_death, death_idx + 1, seq_lengths)
    volumes = jnp.where(
        any_death[:, None] & (idx[None, :] >= death_idx[:, None]),
        MAX_VALUE, volumes)

    treatments = jnp.concatenate(
        [jnp.broadcast_to(treatment[:, None], (B, seq_length - 1)),
         jnp.zeros((B, 1), treatment.dtype)], axis=1).astype(dtype)
    return volumes, treatments, seq_lengths


# ---------------------------------------------------------------------------
# One-step counterfactuals (pkpd_simulation.py:352-471)

@partial(jax.jit, static_argnums=(2, 3), static_argnames=('dtype',))
def _simulate_cf_1_step_full(params, key, seq_length: int, add_noise: bool,
                             dtype=jnp.float32):
    num_patients = params['initial_volumes'].shape[0]
    key, sub = random.split(key)
    # unused draw, kept for split-order parity with the reference (:380-381)
    _ = random.uniform(sub, (num_patients, seq_length - 1), dtype)
    key, sub = random.split(key)
    treatment_rvs = random.uniform(sub, (num_patients,), dtype)
    volumes, actions, seq_lengths = _simulate_cf_1_step_core(
        params, treatment_rvs, seq_length, dtype=dtype)
    if add_noise:
        volumes = _add_observation_noise_always(volumes, params, key)
    rows_pp = volumes.shape[1]
    statics0 = jnp.repeat(params['observed_static_c_0'], rows_pp)
    statics1 = jnp.repeat(params['observed_static_c_1'], rows_pp)
    return volumes, actions, seq_lengths, statics0, statics1


def simulate_counterfactual_1_step(params, seq_length: int, key,
                                   equation: Equation,
                                   dtype=None) -> dict:
    dtype = dtype or default_float()
    add_noise = equation.name.split('_')[-1] in ('B', 'C', 'D')
    volumes, actions, seq_lengths, statics0, statics1 = jax.device_get(
        _simulate_cf_1_step_full(params, key, seq_length, add_noise,
                                 dtype=dtype))
    out = {
        'cancer_volume': volumes.reshape(-1, volumes.shape[-1]),
        'treatment_application': actions.reshape(-1, actions.shape[-1]),
        'sequence_lengths': seq_lengths.reshape(-1),
        'observed_static_c_0': statics0,
        'observed_static_c_1': statics1,
    }
    assert not np.any(np.isnan(out['cancer_volume']))
    return out


@partial(jax.jit, static_argnums=(2,), static_argnames=('dtype',))
def _simulate_cf_1_step_core(params, treatment_rvs, seq_length: int,
                             dtype=jnp.float64):
    """All (patient, time, {factual, flipped-treatment}) rows at once.

    For every prefix end t (0..T-2) the reference emits a factual row holding
    ``volumes[:t+2]`` and a counterfactual row whose last entry restarts from
    ``volumes[t]`` under the flipped arm (:403-419).  Both are closed-form
    from the factual trajectory and the two decay factors, so the whole
    ``[B, 2(T-1), T]`` tensor is one broadcasted select.
    """
    treatment = _treatment_from_rv(params, treatment_rvs)          # [B]
    dt = jnp.asarray(MAX_TIME_HORIZON / seq_length, dtype)
    substeps = _substeps_for(seq_length)
    volumes = _factual_volumes(params, treatment, seq_length - 1, dtype, dt,
                               substeps)
    B, T = volumes.shape                                           # T = 60

    cf_treatment = 1 - treatment
    c_cf = jnp.where(cf_treatment == 1, params['hidden_C_1'],
                     params['hidden_C_0']).astype(dtype)
    f_cf = _decay_factor(c_cf, dt, substeps)                       # [B]
    # counterfactual next-step value from every factual state
    cf_next = volumes[:, :-1] * f_cf[:, None]                      # [B, T-1]

    t_grid = jnp.arange(T - 1)                                     # prefix end
    j_grid = jnp.arange(T)
    TT, J = t_grid[:, None], j_grid[None, :]                       # [T-1, T]

    # factual rows: volumes[:t+2] then zero-pad
    fact_rows = jnp.where((J <= TT + 1)[None], volumes[:, None, :],
                          0.0)                                     # [B,T-1,T]
    # counterfactual rows: volumes[:t+1], then cf_next[t] at j==t+1
    cf_rows = jnp.where((J <= TT)[None], volumes[:, None, :], 0.0)
    cf_rows = jnp.where((J == TT + 1)[None],
                        cf_next[:, :, None] * jnp.ones_like(J, dtype),
                        cf_rows)

    treat_b = treatment.astype(dtype)[:, None, None]
    fact_actions = jnp.where((J <= TT)[None],
                             treat_b * jnp.ones((1, T - 1, T), dtype), 0.0)
    cf_actions = jnp.where((J < TT)[None],
                           treat_b * jnp.ones((1, T - 1, T), dtype), 0.0)
    cf_actions = jnp.where((J == TT)[None],
                           (1.0 - treat_b) * jnp.ones((1, T - 1, T), dtype),
                           cf_actions)

    # interleave factual/cf rows exactly like the reference append order
    rows = jnp.stack([fact_rows, cf_rows], axis=2).reshape(B, 2 * (T - 1), T)
    actions = jnp.stack([fact_actions, cf_actions], axis=2) \
        .reshape(B, 2 * (T - 1), T)
    # reference actions get one zero column appended post-padding (:452);
    # padding above already reaches width T with last column zero for every
    # row (max treatment prefix is T-1 entries).
    seq_lengths = jnp.broadcast_to(
        jnp.repeat(t_grid + 1, 2)[None, :], (B, 2 * (T - 1)))
    return rows, actions, seq_lengths


# ---------------------------------------------------------------------------
# Treatment-sequence counterfactuals (pkpd_simulation.py:474-667)

def simulate_counterfactuals_treatment_seq(params, seq_length: int,
                                           projection_horizon: int, key,
                                           equation: Equation,
                                           cf_seq_mode='sliding_treatment',
                                           dtype=None) -> dict:
    dtype = dtype or default_float()
    assert cf_seq_mode in ('sliding_treatment', 'random_trajectories')
    add_noise = equation.name.split('_')[-1] in ('B', 'C', 'D')
    volumes, actions, seq_lengths, statics0, statics1 = jax.device_get(
        _simulate_cf_seq_full(params, key, seq_length, projection_horizon,
                              cf_seq_mode, add_noise, dtype=dtype))
    out = {
        'cancer_volume': volumes.reshape(-1, volumes.shape[-1]),
        'treatment_application': actions.reshape(-1, actions.shape[-1]),
        'sequence_lengths': seq_lengths.reshape(-1),
        'observed_static_c_0': statics0,
        'observed_static_c_1': statics1,
    }
    assert not np.any(np.isnan(out['cancer_volume']))
    return out


@partial(jax.jit, static_argnums=(2, 3, 4, 5), static_argnames=('dtype',))
def _simulate_cf_seq_full(params, key, seq_length: int, ph: int,
                          cf_seq_mode: str, add_noise: bool,
                          dtype=jnp.float32):
    num_patients = params['initial_volumes'].shape[0]
    key, sub = random.split(key)
    _ = random.uniform(sub, (num_patients, seq_length + ph - 1), dtype)
    key, sub = random.split(key)
    treatment_rvs = random.uniform(sub, (num_patients,), dtype)
    key, *subkeys = random.split(key, num_patients + 1)
    subkeys = jnp.stack(subkeys)

    if cf_seq_mode == 'sliding_treatment':
        eye = jnp.eye(ph, dtype=jnp.int32)
        plans = jnp.concatenate([eye, 1 - eye], axis=0)            # [2ph, ph]
        plans = jnp.broadcast_to(plans[None, None],
                                 (num_patients, seq_length - 1, 2 * ph, ph))
    else:
        # one independent plan block per (patient, prefix end) — same
        # distribution as the reference's in-scan splits (:489-492)
        def per_patient(k):
            def step(carry, _):
                # reference splits twice: scan_fn splits the carry
                # (pkpd_simulation.py:507), then the plan builder splits the
                # sub-key again before drawing (:491-492)
                carry, s = random.split(carry)
                s = random.split(s)[1]
                return carry, random.randint(s, (2 * ph, ph), 0, 2)
            _, p = lax.scan(step, k, None, length=seq_length - 1)
            return p
        plans = jax.vmap(per_patient)(subkeys)

    volumes, actions, seq_lengths = _simulate_cf_seq_core(
        params, treatment_rvs, plans, seq_length, ph, dtype=dtype)
    if add_noise:
        volumes = _add_observation_noise_always(volumes, params, key)
    rows_pp = volumes.shape[1]
    statics0 = jnp.repeat(params['observed_static_c_0'], rows_pp)
    statics1 = jnp.repeat(params['observed_static_c_1'], rows_pp)
    return volumes, actions, seq_lengths, statics0, statics1


@partial(jax.jit, static_argnums=(3, 4), static_argnames=('dtype',))
def _simulate_cf_seq_core(params, treatment_rvs, plans, seq_length: int,
                          ph: int, dtype=jnp.float64):
    """Every (patient, prefix end t, plan p) row at once.

    The reference scans prefixes sequentially, integrating each of the
    ``2*ph`` plans ``ph`` steps from the current factual state (:505-514).
    Closed form: a plan's trajectory is the launch state times the running
    product of per-arm decay factors selected by the plan, so the full
    ``[B, T-1, 2ph, ph]`` counterfactual block is one cumprod.
    """
    B = treatment_rvs.shape[0]
    treatment = _treatment_from_rv(params, treatment_rvs)
    dt = jnp.asarray(MAX_TIME_HORIZON / seq_length, dtype)
    substeps = _substeps_for(seq_length)
    # factual grid has seq_length+1 points here (:537)
    volumes = _factual_volumes(params, treatment, seq_length, dtype, dt,
                               substeps)

    f_arm = jnp.stack([
        _decay_factor(params['hidden_C_0'].astype(dtype), dt, substeps),
        _decay_factor(params['hidden_C_1'].astype(dtype), dt, substeps)],
        axis=1)

    # per-plan step factors then running products    [B, T-1, 2ph, ph]
    plan_idx = plans.astype(jnp.int32)                  # [B, T-1, 2ph, ph]
    plan_f = jnp.where(plan_idx == 1, f_arm[:, 1, None, None, None],
                       f_arm[:, 0, None, None, None])
    plan_cum = jnp.cumprod(plan_f, axis=-1)
    launch = volumes[:, 1:seq_length]                   # [B, T-1] state v[t+1]
    cf_vols = launch[:, :, None, None] * plan_cum       # [B, T-1, 2ph, ph]

    T_out = seq_length + ph                             # padded row width
    n_pref = seq_length - 1
    t_grid = jnp.arange(n_pref)[:, None]                # prefix index i
    j_grid = jnp.arange(T_out)[None, :]

    # volumes row for (i, p): volumes[:i+2] ++ cf_vols[i, p, :]  (pad to T_out)
    pad_vol = jnp.pad(volumes, ((0, 0), (0, T_out - volumes.shape[1])))
    base = jnp.where((j_grid <= t_grid + 1)[None, :, None, :],
                     pad_vol[:, None, None, :], 0.0)    # [B, T-1, 1, T_out]
    # place cf entries at j = i+2 .. i+1+ph
    k = j_grid - (t_grid + 2)                           # [T-1, T_out]
    k_clip = jnp.clip(k, 0, ph - 1)
    cf_part = jnp.take_along_axis(
        cf_vols,                                        # [B, T-1, 2ph, ph]
        jnp.broadcast_to(k_clip[None, :, None, :],
                         (B, n_pref, 2 * ph, T_out)), axis=-1)
    in_cf = ((k >= 0) & (k < ph))[None, :, None, :]
    rows = jnp.where(in_cf, cf_part, base)              # [B, T-1, 2ph, T_out]

    # actions row: treatment for j <= i, plan for j in [i+1, i+ph], zero after
    ka = j_grid - (t_grid + 1)
    ka_clip = jnp.clip(ka, 0, ph - 1)
    plan_part = jnp.take_along_axis(
        plan_idx, jnp.broadcast_to(ka_clip[None, :, None, :],
                                   (B, n_pref, 2 * ph, T_out)), axis=-1)
    in_plan = ((ka >= 0) & (ka < ph))[None, :, None, :]
    fact_part = jnp.where((j_grid <= t_grid)[None, :, None, :],
                          treatment[:, None, None, None], 0)
    actions = jnp.where(in_plan, plan_part, fact_part).astype(dtype)

    rows = rows.reshape(B, n_pref * 2 * ph, T_out)
    actions = actions.reshape(B, n_pref * 2 * ph, T_out)
    seq_lengths = jnp.broadcast_to(
        jnp.repeat(jnp.arange(n_pref) + 1 + ph, 2 * ph)[None, :],
        (B, n_pref * 2 * ph))
    return rows, actions, seq_lengths


# ---------------------------------------------------------------------------
# Scaling (pkpd_simulation.py:670-693)

def get_scaling_params(sim: dict):
    """Mean/std of active cancer-volume entries + statics, as plain dicts."""
    vol = np.asarray(sim['cancer_volume'])
    lengths = np.asarray(sim['sequence_lengths']).astype(np.int64)
    mask = np.arange(vol.shape[1])[None, :] < lengths[:, None]
    active = vol[mask]
    means = {'cancer_volume': float(active.mean()),
             'observed_static_c_0': float(np.mean(sim['observed_static_c_0'])),
             'observed_static_c_1': float(np.mean(sim['observed_static_c_1']))}
    stds = {'cancer_volume': float(active.std()),
            'observed_static_c_0': float(np.std(sim['observed_static_c_0'])),
            'observed_static_c_1': float(np.std(sim['observed_static_c_1']))}
    return means, stds
