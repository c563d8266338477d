"""Fused north-star pipeline: simulate → design → QR in ONE device program.

The standard path (PkpdDatasetCollection + SINDyRegressor.fit +
_fine_tuned_rollout) pays host-side dataset processing plus several
host↔device roundtrips per stage.  This path keeps the cohort resident on
the device end-to-end:

  program A  simulate_factual + finite-difference design + per-arm QR
             reduction, one dispatch; only two F×(F+1) triangles return
             to the host,
  host       the F×F f64 STLSQ thresholding iteration (microseconds),
  program B  the LM fine-tune (the Pallas/Triton kernel on a GPU, the
             XLA scan elsewhere) consuming the device-resident cohort,
  one fetch  predictions for the metric.

Both paths draw the bit-identical cohort (same PRNGKey discipline as
PkpdDatasetCollection.subset) and produce the same global coefficients —
asserted in tests/test_northstar.py.

Reference scope: train_sindy.main's simulate+fit+predict
(/root/reference/run.py:265-303, libs_m/ct/runnables/train_sindy.py:21-113)
collapsed to two device programs.
"""

from __future__ import annotations

from functools import partial
from time import time

import jax
import jax.numpy as jnp
import numpy as np

from insite_tpu.core.constants import MAX_VALUE, STANDARD_DT
from insite_tpu.discovery.library import PolynomialLibrary
from insite_tpu.discovery.stlsq import _qr_reduce, stlsq_from_qr
from insite_tpu.models.sindy import (_eq4_design,
                                     insite_gn_finetune_predict,
                                     insite_gn_finetune_predict_pallas)
from insite_tpu.ops import kernels_default
from insite_tpu.sim import pkpd


@partial(jax.jit, static_argnames=('n', 'seq_length', 'equation_name',
                                   'library', 'conf_coeff', 'dtype'))
def _sim_design_qr(key, n: int, seq_length: int, equation_name: str,
                   library, conf_coeff: float, dtype):
    """Program A: cohort simulation + EQ_4 design build + per-arm QR.

    Key discipline matches PkpdDatasetCollection.subset exactly (split for
    params, split for the factual sim), so the cohort is bit-identical to
    the standard path's train_f."""
    eq = pkpd.Equation[equation_name]
    add_noise = equation_name.split('_')[-1] in ('B', 'C', 'D')
    key, sub = jax.random.split(key)
    params = pkpd.generate_params(n, conf_coeff=conf_coeff, window_size=15,
                                  lag=0, key=sub, equation=eq, dtype=dtype)
    key, sub = jax.random.split(key)
    vol, treat, lengths = pkpd._simulate_factual_full(
        params, sub, seq_length, add_noise, dtype=dtype)
    statics = jnp.stack([params['observed_static_c_0'],
                         params['observed_static_c_1']], axis=-1)

    # EQ_4 fit semantics (SINDyRegressor.fit): offset=1, smoothed 4th-order
    # finite differences
    eff_len = jnp.maximum(lengths - 1, 2)
    flat_theta, flat_y, flat_ok, flat_arm = _eq4_design(
        vol, statics, treat, eff_len, STANDARD_DT, library=library,
        joint=False, smooth=True, fd_order=4)
    triangles = []
    for a in range(2):
        w = (flat_ok & (flat_arm == a)).astype(flat_theta.dtype)
        triangles.append(_qr_reduce(flat_theta, flat_y, w))
    return triangles, (vol, statics, treat, lengths)


@jax.jit
def _factual_rmse(preds, vol, lengths):
    """Normalised factual RMSE (%, orig = per-timestep-mean then sqrt,
    all = pooled), accumulated in f32 on device."""
    T = preds.shape[1]
    active = (jnp.arange(T)[None, :] < lengths[:, None]).astype(preds.dtype)
    err2 = jnp.where(active > 0, (preds - vol[:, 1:]) ** 2, 0.0)
    mse_orig = (err2.sum(0) / jnp.maximum(active.sum(0), 1.0)).mean()
    rmse_orig = jnp.sqrt(mse_orig) / MAX_VALUE * 100.0
    rmse_all = jnp.sqrt(err2.sum() / active.sum()) / MAX_VALUE * 100.0
    return rmse_orig, rmse_all


def discover_northstar(n_train: int, seed: int = 0,
                       equation_name: str = 'EQ_4_D',
                       conf_coeff: float = 2.0, seq_length: int = 60,
                       threshold: float = 0.1, alpha: float = 0.5,
                       max_stlsq_iter: int = 100, dtype=None) -> dict:
    """Program A plus the host STLSQ: the north-star cohort, resident on
    the device, and its global coefficients [2, F] (numpy)."""
    from insite_tpu.core.dtypes import default_float
    dtype = dtype or default_float()
    library = PolynomialLibrary(n_inputs=3)     # [y, c0, c1]

    t0 = time()
    triangles, (vol, statics, treat, lengths) = _sim_design_qr(
        jax.random.PRNGKey(seed), n_train, seq_length, equation_name,
        library, conf_coeff, dtype)
    # ONE batched fetch of the two tiny triangles (F x F + F each)
    host_tri = jax.device_get(triangles)
    t_sim_design = time() - t0

    t1 = time()
    coefs = np.stack([
        stlsq_from_qr(R, qty, threshold, alpha, max_iter=max_stlsq_iter)[0]
        for R, qty in host_tri]).astype(np.asarray(0, dtype).dtype)
    return {'library': library, 'coefs': coefs, 'vol': vol,
            'statics': statics,
            'arms': treat[:, :seq_length - 1].astype(jnp.int32),
            'lengths': lengths, 't_sim_design': t_sim_design,
            't_stlsq': time() - t1}


def fused_northstar(n_train: int, seed: int = 0,
                    equation_name: str = 'EQ_4_D', conf_coeff: float = 2.0,
                    seq_length: int = 60, threshold: float = 0.1,
                    alpha: float = 0.5, lam: float = 10.0,
                    gn_iters: int = 12, projection_horizon: int = 1,
                    max_stlsq_iter: int = 100, use_pallas=None,
                    dtype=None) -> dict:
    """The whole north-star workload (simulate + discover + fine-tune) in
    two device programs.  Returns the global coefs, the fine-tuned
    predictions and per-patient coefs (left on the device), per-stage
    timings and the factual normalised RMSEs of the fine-tuned predictions.

    use_pallas: None picks the kernel fine-tune where `kernels_default()`
    says so (a GPU backend) and the XLA fine-tune elsewhere; True / False
    force one."""
    if use_pallas is None:
        use_pallas = kernels_default()
    d = discover_northstar(n_train, seed, equation_name, conf_coeff,
                           seq_length, threshold, alpha, max_stlsq_iter,
                           dtype)
    library, coefs, vol, statics, arms, lengths = (
        d['library'], d['coefs'], d['vol'], d['statics'], d['arms'],
        d['lengths'])
    t_sim_design, t_stlsq = d['t_sim_design'], d['t_stlsq']

    active_idx = tuple(int(i) for i in
                       np.flatnonzero(np.abs(coefs).reshape(-1) > 1e-3))
    prev = vol[:, :-1]
    finetune = (insite_gn_finetune_predict_pallas
                if use_pallas and active_idx else
                partial(insite_gn_finetune_predict, joint=False))
    t2 = time()
    preds, patient_coefs = finetune(
        library, jnp.asarray(coefs), prev, statics, arms, lengths,
        STANDARD_DT, lam=lam, projection_horizon=projection_horizon,
        gn_iters=gn_iters, y_clip=None, active_idx=active_idx)
    preds.block_until_ready()
    t_finetune = time() - t2

    # factual normalised RMSE (metrics.normalised_masked_rmse semantics on
    # the unscaled arrays: outputs[t] = vol[t+1], active = t < L) — reduced
    # on the device so only two scalars are fetched, not the [B, T] preds
    t3 = time()
    rmse_orig, rmse_all = jax.device_get(
        _factual_rmse(preds, vol, lengths))
    rmse_orig, rmse_all = float(rmse_orig), float(rmse_all)
    t_metric = time() - t3

    names = ['x0', 'u0', 'u1']
    eq_strs = [library.pretty_equation(coefs[a], names) for a in range(2)]
    return {
        'coefs': coefs, 'preds': preds, 'patient_coefs': patient_coefs,
        'used_pallas': bool(use_pallas and active_idx),
        'global_equation_string': ' | '.join(
            f'Treatment {a}: x_dot = {s}' for a, s in enumerate(eq_strs)),
        'rmse_orig': rmse_orig, 'rmse_all': rmse_all,
        't_sim_design': t_sim_design, 't_stlsq': t_stlsq,
        't_finetune': t_finetune, 't_metric': t_metric,
        'total': t_sim_design + t_stlsq + t_finetune + t_metric,
    }
