#!/usr/bin/env python
"""On-card smoke test of the INSITE main path.

Runs, in one process on one GPU:

1. environment: JAX version and devices, the card's name and power limit,
   the compile-cache directory, which optional packages import;
2. kernel parity at real widths: the Pallas/Triton rollout kernels
   (`insite_tpu.ops.pallas_rollout`) against the plain XLA rollout
   (`models.sindy.batched_rollout`, and `jax.jacfwd` through it for the
   sensitivities) on the 10k-patient north-star layout and on the 4-arm,
   y_clip tumor layout;
3. the 10k-patient north star (`harness.northstar.fused_northstar`, the
   path `bench.py` times) with the kernel fine-tune and with the XLA
   fine-tune, checked against each other patient by patient and against a
   CPU f32 run;
4. the protocol cell through `harness.runner.run_experiment` (the function
   `run.py` drives): insite and sindy on EQ_4_D and cancer_sim, seed 0,
   1000/100/100 patients, checked against CPU f32 runs of the same calls.

With ``--four-cards`` it runs only the mesh phase on four GPUs: a
seed-sharded vectorized EQ_4_D column, the STLSQ gram all-reduce over
row-sharded design rows and a row-sharded INSITE fine-tune, each against
the same call unsharded on one card.

Usage:
    python chip_smoke.py                # phases 1-4, one GPU
    python chip_smoke.py --four-cards   # mesh phase, four GPUs

The last line of standard output on success is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
A failed phase, or no GPU, exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# CPU f32 values of the same calls, produced by
#   JAX_PLATFORMS=cpu python -c \
#       'import chip_smoke; chip_smoke.cpu_references()'
# (factual normalised RMSE %, and 1-step counterfactual normalised RMSE %)
CPU_NORTHSTAR_RMSE_ORIG = 0.020187480375170708
CPU_PROTOCOL_RMSE = {
    ('EQ_4_D', 'insite'): 0.02018323270576087,
    ('EQ_4_D', 'sindy'): 0.11361519679110726,
    ('cancer_sim', 'insite'): 0.9495034882057165,
    ('cancer_sim', 'sindy'): 1.3757540680042688,
}
# 10-seed means of the same cells (PARITY.md, 1-step counterfactual table)
PARITY_MEANS = {
    ('EQ_4_D', 'insite'): 0.0206,
    ('EQ_4_D', 'sindy'): 0.117,
    ('cancer_sim', 'insite'): 0.85,
    ('cancer_sim', 'sindy'): 1.35,
}
PROTOCOL_PATIENTS = (1000, 100, 100)
NORTHSTAR_PATIENTS = 10_000


class PhaseFailed(Exception):
    pass


def result_line(devices) -> str:
    """The script's last line: the device as JAX reports it."""
    from insite_tpu.utils import device_record
    return json.dumps({'ok': True, 'device': device_record(devices)})


def optional_packages() -> dict:
    return {name: importlib.util.find_spec(name) is not None
            for name in ('flax', 'pandas', 'yaml')}


def _blocked(fn, *args, **kwargs):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


def _report(what, card, compile_s=None, warm_s=None, **extra):
    parts = [f'[{what}]']
    if compile_s is not None:
        parts.append(f'first call (compile) {compile_s:.3f}s')
    if warm_s is not None:
        parts.append(f'warm {warm_s:.4f}s')
    parts += [f'{k}={v}' for k, v in extra.items()]
    parts.append(f'| card: {card}')
    print(' '.join(parts), flush=True)


def _check_close(what, got, want, rtol, atol=0.0, failures=None):
    """assert_allclose with the maximum errors printed either way.  With a
    `failures` list, a miss is appended to it instead of raised."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not np.isfinite(got).all():
        raise PhaseFailed(f'{what}: non-finite values')
    err = np.abs(got - want)
    max_abs = float(err.max())
    rel = err / np.maximum(np.abs(want), 1e-30)
    at = np.unravel_index(np.argmax(rel), rel.shape) if rel.ndim else ()
    print(f'  {what}: max abs err {max_abs:.3e}, max rel err '
          f'{float(rel.max()):.3e} at {at} (reference value '
          f'{float(want[at]):.6g}; rtol {rtol:g}, atol {atol:g})',
          flush=True)
    if not np.all(err <= atol + rtol * np.abs(want)):
        msg = f'{what}: outside rtol {rtol:g} atol {atol:g}'
        if failures is None:
            raise PhaseFailed(msg)
        failures.append(msg)


# ---------------------------------------------------------------------------
# phases


def phase_environment(card, devices):
    import jax
    print(f'jax {jax.__version__} | devices {jax.devices()} | device_kind '
          f'{devices[0].device_kind}', flush=True)
    print(f'card: {card}', flush=True)
    print(f'compile cache: {jax.config.jax_compilation_cache_dir}',
          flush=True)
    print(f'optional packages importable: {optional_packages()}',
          flush=True)


def _parity_layout(card, name, library, coefs, y0, statics, arms, dt,
                   y_clip, scaled_state_atol=False):
    """Kernel vs XLA reference for one layout: forward rollout (states)
    and rollout + forward sensitivities (states, Jacobian).

    scaled_state_atol: compare states with an absolute tolerance of 1e-6
    times the largest state as well.  A trajectory whose constant terms
    drive it through cancellation toward the clip at 0 keeps an absolute
    error at f32 rounding of the trajectory's scale, so the relative error
    of those few near-zero states says nothing about the kernel."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from insite_tpu.models.sindy import batched_rollout
    from insite_tpu.ops import (pallas_batched_rollout,
                                pallas_rollout_with_sens)

    B, T = arms.shape
    A, F = coefs.shape[-2:]
    active_idx = tuple(int(i) for i in np.flatnonzero(
        np.abs(np.asarray(coefs[0])).reshape(-1) > 1e-3))
    act = jnp.asarray(active_idx)

    with jax.default_matmul_precision('highest'):
        ref = jax.block_until_ready(batched_rollout(
            library, coefs, y0, statics, arms, dt, y_clip=y_clip))

        def roll_one(c_red, c_full, y0_i, st_i, arm_i):
            c = c_full.reshape(-1).at[act].set(c_red).reshape(1, A, F)
            return batched_rollout(library, c, y0_i[None], st_i[None],
                                   arm_i[None], dt, shared_coefs=True,
                                   y_clip=y_clip)[0]

        c_red = coefs.reshape(B, -1)[:, act]
        ref_sens = jax.block_until_ready(jax.jit(jax.vmap(
            jax.jacfwd(roll_one)))(c_red, coefs, y0, statics, arms))

    out, t_compile = _blocked(pallas_batched_rollout, library, coefs, y0,
                              statics, arms, dt, y_clip=y_clip)
    _, t_warm = _blocked(pallas_batched_rollout, library, coefs, y0,
                         statics, arms, dt, y_clip=y_clip)
    _report(f'parity {name} insite_rollout B={B} T={T} A={A} F={F}', card,
            t_compile, t_warm)
    state_atol = (1e-6 * float(jnp.max(jnp.abs(ref))) if scaled_state_atol
                  else 0.0)
    _check_close(f'{name} rollout states', out, ref, rtol=1e-5,
                 atol=state_atol)

    (y, sens), t_compile = _blocked(pallas_rollout_with_sens, library,
                                    coefs, y0, statics, arms, dt,
                                    active_idx, y_clip=y_clip)
    _, t_warm = _blocked(pallas_rollout_with_sens, library, coefs, y0,
                         statics, arms, dt, active_idx, y_clip=y_clip)
    _report(f'parity {name} insite_rollout_sens Kr={len(active_idx)}',
            card, t_compile, t_warm)
    _check_close(f'{name} sens-kernel states', y, ref, rtol=1e-5,
                 atol=state_atol)
    _check_close(f'{name} sensitivities', sens, ref_sens, rtol=2e-4,
                 atol=1e-5)


def phase_kernel_parity(card, devices):
    import jax.numpy as jnp
    import numpy as np

    from insite_tpu.core.constants import STANDARD_DT
    from insite_tpu.harness.northstar import discover_northstar
    from insite_tpu.sim.tumor import TUMOUR_DEATH_THRESHOLD

    # north-star layout: the cohort and support the 10k north-star fit
    # finds, per-patient coefficients spread around the global fit
    d = discover_northstar(NORTHSTAR_PATIENTS, seed=0, dtype=jnp.float32)
    B = NORTHSTAR_PATIENTS
    rng = np.random.RandomState(0)
    coefs = jnp.asarray(d['coefs'][None] *
                        (1 + 0.05 * rng.randn(B, 1, 1)), jnp.float32)
    _parity_layout(card, 'north-star', d['library'], coefs,
                   d['vol'][:, 0], d['statics'], d['arms'], STANDARD_DT,
                   None)

    # tumor layout: a cancer_sim SINDy fit (4 arms, [y, one static]
    # library), its 1000 training patients tiled to 10k rows with
    # per-row coefficients spread around the fit, state clipped to the
    # simulators' [0, TUMOUR_DEATH_THRESHOLD]
    from insite_tpu.data import make_collection
    from insite_tpu.models.sindy import SINDyConfig, SINDyRegressor
    coll = make_collection('cancer_sim', {'train': 1000, 'val': 10,
                                          'test': 10}, seed=0, coeff=2.0)
    m = SINDyRegressor(SINDyConfig(dataset_name='CANCER_SIM',
                                   sindy_threshold=0.001), coll)
    m.fit(coll.train_f)
    print(f'  tumor layout model: {m.global_equation_string}', flush=True)
    prev, statics, arms, _ = m._rollout_args(coll.train_f)
    reps = -(-B // prev.shape[0])
    prev, statics, arms = (jnp.tile(x, (reps,) + (1,) * (x.ndim - 1))[:B]
                           for x in (prev, statics, arms))
    A = m.coefs.shape[0]
    coefs = jnp.asarray(m.coefs[None] * (1 + 0.05 * rng.randn(B, A, 1)),
                        jnp.float32)
    _parity_layout(card, 'tumor', m.library, coefs, prev[:, 0], statics,
                   arms, STANDARD_DT, (0.0, float(TUMOUR_DEATH_THRESHOLD)),
                   scaled_state_atol=True)


def phase_northstar(card, devices):
    """fused_northstar at 10k with the kernel fine-tune and with the XLA
    fine-tune, each run twice (compile, then warm)."""
    import numpy as np

    from insite_tpu.harness.northstar import fused_northstar
    runs = {use_pallas: [fused_northstar(NORTHSTAR_PATIENTS, seed=0,
                                         equation_name='EQ_4_D',
                                         use_pallas=use_pallas)
                         for _ in ('cold', 'warm')]
            for use_pallas in (True, False)}
    for use_pallas, (cold, warm) in runs.items():
        assert warm['used_pallas'] == use_pallas
        path = 'kernel' if use_pallas else 'xla'
        _report(f'north star 10k fine-tune={path}', card, cold['total'],
                warm['total'], sim_design_s=f"{warm['t_sim_design']:.4f}",
                stlsq_s=f"{warm['t_stlsq']:.4f}",
                finetune_s=f"{warm['t_finetune']:.4f}",
                metric_s=f"{warm['t_metric']:.4f}",
                rmse_orig=f"{warm['rmse_orig']!r}")
    k, x = runs[True][1], runs[False][1]
    print(f"  global model: {k['global_equation_string']}", flush=True)
    if not np.array_equal(np.abs(k['coefs']) > 1e-3,
                          np.abs(x['coefs']) > 1e-3):
        raise PhaseFailed('north star: sparse supports differ')
    _check_close('north-star global coefs kernel vs xla run', k['coefs'],
                 x['coefs'], rtol=1e-5)
    # the fine-tune itself, patient by patient: the kernel's forward
    # sensitivities and the XLA jvp differ by f32 round-off (1e-6 relative,
    # phase 2), which twelve Gauss-Newton solves carry into the fitted
    # coefficients and the predictions (on an H100: predictions 1.3e-5
    # absolute at most, coefficients 1.3e-4 relative at most)
    _check_close('north-star fine-tuned preds kernel vs xla',
                 k['preds'], x['preds'], rtol=1e-4, atol=1e-5)
    _check_close('north-star per-patient coefs kernel vs xla',
                 k['patient_coefs'], x['patient_coefs'], rtol=1e-3,
                 atol=1e-5)
    _check_close('north-star factual RMSE kernel vs xla', k['rmse_orig'],
                 x['rmse_orig'], rtol=1e-3)
    _check_close('north-star factual RMSE vs CPU f32', k['rmse_orig'],
                 CPU_NORTHSTAR_RMSE_ORIG, rtol=1e-2)


def protocol_cell(report=None):
    """run_experiment for the protocol cell; {(dataset, method): 1-step
    counterfactual normalised RMSE %}."""
    from insite_tpu.harness.config import RunConfig
    from insite_tpu.harness.runner import Experiment, run_experiment
    n_train, n_val, n_test = PROTOCOL_PATIENTS
    cfg = RunConfig(train_samples=n_train, val_samples=n_val,
                    test_samples=n_test, metrics_jsonl='')
    out = {}
    for key in CPU_PROTOCOL_RMSE:
        dataset, method = key
        t0 = time.perf_counter()
        r = run_experiment(dataset, method, 0, 2.0, cfg,
                           Experiment.MAIN_TABLE)
        out[key] = r['encoder_test_rmse_orig']
        if report:
            report(key, time.perf_counter() - t0, r)
    return out


def phase_protocol(card, devices):
    def report(key, seconds, r):
        _report(f'protocol {key[0]} {key[1]} seed 0', card,
                compile_s=seconds,
                one_step_cf_rmse=f"{r['encoder_test_rmse_orig']!r}",
                cpu_f32=f'{CPU_PROTOCOL_RMSE[key]!r}',
                parity_10_seed_mean=PARITY_MEANS[key])

    rmses = protocol_cell(report)
    for key, got in rmses.items():
        _check_close(f'protocol {key} 1-step cf RMSE vs CPU f32', got,
                     CPU_PROTOCOL_RMSE[key], rtol=0.02)


def _peak_bytes(devices):
    """Peak device memory in use per card (None where not reported)."""
    return [(d.memory_stats() or {}).get('peak_bytes_in_use')
            for d in devices]


def phase_four_cards(card, devices):
    """Over a 4-card batch mesh, each against the same call unsharded on
    card 0: a seed-sharded vectorized INSITE column, the STLSQ gram
    all-reduce over row-sharded design rows, and a row-sharded INSITE
    fine-tune.  Every check runs; the misses are raised together."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from insite_tpu.core.constants import STANDARD_DT
    from insite_tpu.data import PkpdDatasetCollection
    from insite_tpu.discovery.stlsq import stlsq
    from insite_tpu.harness.northstar import discover_northstar
    from insite_tpu.harness.vectorized import vectorized_eq4_sweep
    from insite_tpu.models.sindy import (SINDyConfig, SINDyRegressor,
                                         _eq4_design)
    from insite_tpu.parallel import batch_mesh

    mesh = batch_mesh(devices)
    failures = []
    kw = dict(n_seeds=8, n_train=1000, n_test=100, method='insite')
    t0 = time.perf_counter()
    sharded = vectorized_eq4_sweep('EQ_4_D', mesh=mesh, **kw)
    t_sharded = time.perf_counter() - t0
    peaks = _peak_bytes(devices)
    print(f'  peak bytes in use per card after the sharded column: {peaks}',
          flush=True)
    if None not in peaks and not all(peaks):
        failures.append('the seed-sharded column left a card unused')
    with jax.default_device(devices[0]):
        t0 = time.perf_counter()
        single = vectorized_eq4_sweep('EQ_4_D', **kw)
        t_single = time.perf_counter() - t0
    _report('4-card seed-sharded EQ_4_D insite column, 8 seeds', card,
            compile_s=t_sharded, one_card_s=f'{t_single:.3f}')
    # the 6-step metric is a 0.03-0.1% error of the fine-tuned rollouts:
    # round-off that differs between the separately compiled sharded and
    # one-card programs (measured 1.3e-5 relative on the H100) moves it
    # more than the 1-step metric
    for metric, rtol in (('encoder_test_rmse_orig', 1e-5),
                         ('decoder_test_rmse_6-step', 1e-4)):
        print(f'  {metric} sharded: {sharded[metric].tolist()}', flush=True)
        _check_close(f'seed-sharded {metric} vs one card', sharded[metric],
                     single[metric], rtol=rtol, failures=failures)

    # STLSQ gram all-reduce: the 1000-patient EQ_4_D design (60k rows),
    # rows sharded over the cards, reduced and solved per arm
    d = discover_northstar(1000, seed=0)
    theta, ydot, ok, arm = _eq4_design(
        d['vol'], d['statics'], d['arms'], jnp.maximum(d['lengths'] - 1, 2),
        STANDARD_DT, library=d['library'], joint=False, smooth=True,
        fd_order=4)

    @jax.jit
    def gram_rhs(th, y, w):            # the reduction stlsq starts with
        return (jnp.einsum('nf,ng,n->fg', th, th, w, precision='highest'),
                jnp.einsum('nf,n->f', th, y * w, precision='highest'))

    rows = NamedSharding(mesh, P('batch'))
    for a in range(2):
        w = (ok & (arm == a)).astype(theta.dtype)
        sharded_in = [jax.device_put(x, rows) for x in (theta, ydot, w)]
        one_in = [jax.device_put(x, devices[0]) for x in (theta, ydot, w)]
        if len(sharded_in[0].sharding.device_set) != 4:
            failures.append('design rows are not on 4 cards')
        # the same sums taken in another order: f32 round-off only.  The
        # gram's terms are all positive (so is every library feature
        # here).  The rhs mixes signs through the derivative: its
        # round-off scales with the sum of its terms' magnitudes, about
        # sqrt(60k) * 6e-8 = 1.5e-5 of it for each of the two orders
        (g_s, r_s), (g_1, r_1) = gram_rhs(*sharded_in), gram_rhs(*one_in)
        _check_close(f'row-sharded arm {a} gram vs one card', g_s, g_1,
                     rtol=1e-5, failures=failures)
        r_mag = np.abs(np.asarray(theta, np.float64)).T @ np.abs(
            np.asarray(ydot, np.float64) * np.asarray(w, np.float64))
        _check_close(f'row-sharded arm {a} rhs vs one card', r_s, r_1,
                     rtol=1e-5, atol=1e-4 * float(r_mag.max()),
                     failures=failures)
        c_s, sup_s = stlsq(*sharded_in[:2], 0.1, 0.5,
                           sample_weight=sharded_in[2], max_iter=100)
        c_1, sup_1 = stlsq(*one_in[:2], 0.1, 0.5, sample_weight=one_in[2],
                           max_iter=100)
        if not np.array_equal(np.asarray(sup_s), np.asarray(sup_1)):
            failures.append(f'arm {a}: sharded STLSQ support differs')
        # the f32 solve of a near-collinear gram magnifies the sums'
        # round-off above by its condition number
        _check_close(f'row-sharded STLSQ arm {a} coefs vs one card', c_s,
                     c_1, rtol=5e-3, atol=1e-7, failures=failures)

    coll = PkpdDatasetCollection(
        conf_coeff=2.0, num_patients={'train': 1000, 'val': 100,
                                      'test': 100},
        equation_str='EQ_4_D', seed=0)
    cfg = SINDyConfig(dataset_name='EQ_4_D', sindy_threshold=0.1,
                      sindy_alpha=0.5, lam=10.0, insite=True,
                      rollout_backend='xla')
    t0 = time.perf_counter()
    m_sh = SINDyRegressor(cfg, coll, mesh=mesh).fit(coll.train_f)
    p_sh, _ = m_sh._fine_tune(coll.train_f, 1)
    jax.block_until_ready(p_sh)
    t_sharded = time.perf_counter() - t0
    if set(p_sh.sharding.device_set) != set(devices) or \
            len(p_sh.addressable_shards) != 4:
        failures.append(f'row-sharded fine-tune lives on '
                        f'{p_sh.sharding.device_set}, not on the 4 cards')
    with jax.default_device(devices[0]):
        m_1 = SINDyRegressor(cfg, coll).fit(coll.train_f)
        p_1, _ = m_1._fine_tune(coll.train_f, 1)
    _report('4-card row-sharded EQ_4_D INSITE fine-tune, 1000 patients',
            card, compile_s=t_sharded)
    n = coll.train_f.data['prev_outputs'].shape[0]
    # fine-tuned coefficients inherit the round-off of the separately
    # compiled programs, as the 6-step metric above does
    _check_close('row-sharded fine-tuned preds vs one card',
                 np.asarray(p_sh)[:n], np.asarray(p_1)[:n], rtol=1e-4,
                 atol=1e-5, failures=failures)
    if failures:
        raise PhaseFailed('; '.join(failures))


def cpu_references():
    """Print the CPU f32 values this script compares against (run with
    JAX_PLATFORMS=cpu; see the constants at the top)."""
    import jax
    assert jax.default_backend() == 'cpu'
    from insite_tpu.harness.northstar import fused_northstar
    r = fused_northstar(NORTHSTAR_PATIENTS, seed=0, equation_name='EQ_4_D')
    print(f'CPU_NORTHSTAR_RMSE_ORIG = {r["rmse_orig"]!r}', flush=True)
    for key, v in protocol_cell().items():
        print(f'    {key!r}: {v!r},', flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--four-cards', action='store_true',
                   help='run only the mesh phase, on four GPUs')
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    from insite_tpu.utils import card_info, require_gpus

    devices = require_gpus(4 if args.four_cards else 1)
    card = card_info()
    phases = ([phase_four_cards] if args.four_cards else
              [phase_environment, phase_kernel_parity, phase_northstar,
               phase_protocol])
    for phase in phases:
        t0 = time.perf_counter()
        phase(card, devices)
        print(f'[{phase.__name__}] passed in '
              f'{time.perf_counter() - t0:.1f}s | card: {card}', flush=True)
    print(f'card: {card}', flush=True)
    print(result_line(devices), flush=True)


if __name__ == '__main__':
    main()
