"""SINDy / INSITE / WSINDy estimators as batched JAX programs.

Re-design of the reference SINDY model (src/models/sindy.py:57-857):

- Discovery: per-treatment-arm STLSQ over a polynomial candidate library
  (sindy.py:184-215), expressed as masked-ridge solves on a feature tensor
  built for the *whole padded cohort at once* — the ragged per-patient
  trajectory splitting of `process_dataset_into_de_format`
  (pkpd/utils.py:523-672) becomes sample masks, not Python loops.
- The discovered model is ``(coefs[A, F], PolynomialLibrary)``; no
  sympy round-trip (the reference needs one only because pysindy returns
  strings, pkpd/utils.py:372-397).
- Prediction: one batched `lax.scan` Euler rollout over every evaluation row
  simultaneously (vs. reference jit(vmap(scan)) per call, sindy.py:413-429).
- INSITE (sindy.py:433-715): per-row BFGS over sparsity-masked coefficients
  with proximal penalty lam*||c - c_global||^2, normalised by 2.5x the
  global model's prefix MSE — `vmap`-ed across all rows and shardable over a
  device mesh on the batch axis (replaces the reference's host-spoofed
  `jax.pmap` + pad hack, sindy.py:668-699,810-841).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from time import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.scipy.optimize import minimize

from insite_tpu.core.constants import STANDARD_DT, STEPS_FOR_DT
from insite_tpu.discovery.differentiate import (finite_difference,
                                                smoothed_finite_difference)
from insite_tpu.discovery.library import PolynomialLibrary
from insite_tpu.discovery.stlsq import stlsq, stlsq_hostsolve
from insite_tpu.models.base import CausalEstimator


@dataclass
class SINDyConfig:
    """Hyperparameters (reference: config/backbone/{sindy,insite,wsindy}.yaml
    + per-dataset threshold/lam table in config/config.yaml:17-28)."""

    dataset_name: str = 'EQ_4_A'
    sindy_threshold: float = 0.1
    sindy_alpha: float = 0.5
    lam: float = 10.0
    insite: bool = False
    wsindy: bool = False
    joint_model: bool = False
    smooth_input_data: bool = False
    use_smoothed_finite_difference: bool = False
    ablation_more_complex_basis_functions: bool = False
    sindy_quantize: bool = False
    sindy_quantize_global_model_round_to: int = 2
    # WSINDy threshold-grid model selection (discovery/wsindy.py::
    # weak_sindy_fit_select): fit the weak system at sindy_threshold x
    # each multiplier in ONE vmapped solve, keep the sparsest candidate
    # whose strong-form training residual is within wsindy_select_tol of
    # the best.  Guards against the hard threshold landing on a
    # degenerate support at unlucky cohort draws (EQ_4_D seed 6).
    wsindy_select: bool = True
    wsindy_threshold_grid: tuple = (0.25, 0.5, 1.0, 2.0, 4.0)
    # the whitened ridge's alpha is in correlation units; 0.5 (the
    # strong-form default) over-shrinks near-collinear weak columns and
    # can collapse the support at unlucky cohort draws (EQ_4_D seed 6:
    # the alpha=0.5 solution scores a 500x worse weak residual than the
    # alpha=0.05 one at every threshold) — so alpha joins the candidate
    # grid and the strong-form score picks per arm
    wsindy_alpha_grid: tuple = (0.5, 0.05, 0.005)
    wsindy_select_tol: float = 0.05
    # tumor-family weak windows (discovery/wsindy.py::weak_system_segments):
    # constant-treatment segments are 1-11 steps (median 1-2) at coeff=2,
    # so windows come in several scales, each kept only when it fits
    # inside one arm's segment.  The reference never ran wsindy outside
    # EQ_4 (run.py:100-103); this extends the weak form to cancer_sim/EQ_5.
    wsindy_tumor_window_lens: tuple = (8, 5, 3)
    projection_horizon: int = 5
    treatment_mode: str = 'multiclass'
    max_stlsq_iter: int = 100   # reference STLSQ max_iter (sindy.py:190)
    # matches jax.scipy BFGS defaults the reference relies on (sindy.py:627);
    # in f32 the 1e-12 tolerance is unreachable, so cap the iterations
    # (convergence is typically < 30 iters; failures fall back to global)
    bfgs_tol: float = 1e-12
    bfgs_maxiter: Optional[int] = None
    # 'gauss_newton' (default): fixed-iteration damped Gauss-Newton over the
    # masked coefficients — same objective and fallback semantics as the
    # reference's BFGS (sindy.py:627), without the vmapped zoom line
    # search that is lock-stepped across the cohort.
    # 'bfgs': jax.scipy BFGS, bit-level reference semantics.
    insite_solver: str = 'gauss_newton'
    gn_iters: int = 12
    # 'auto': the fused Pallas/Triton Euler+library kernels
    # (ops/pallas_rollout.py) for rollouts and the Gauss-Newton fine-tune
    # when the default backend is a GPU, the XLA scan elsewhere; 'xla' /
    # 'pallas' force a backend ('pallas' off the GPU fails: the kernels
    # run on a CPU only in interpret mode, which the tests ask for).
    # joint_model (ABLATION_ONE_ODE) and mesh-sharded regressors always
    # take the XLA scan: the kernel supports neither the joint library's
    # treatment inputs nor a row sharding (see _use_pallas).
    rollout_backend: str = 'auto'
    # fine-tune row chunking: rows per fine-tune dispatch (None = whole
    # cohort in one program; auto-set to 2048 for the degree-4 ablation,
    # whose A*F-tangent Jacobian OOMs a whole-test-set dispatch)
    finetune_chunk: Optional[int] = None
    # rollout state clipping: 'auto' projects tumor-family predictions onto
    # [0, TUMOUR_DEATH_THRESHOLD] — the range the simulators clip the
    # ground-truth volume to at every step (cancer_simulation.py:502,702) —
    # and leaves EQ_4 unclipped; None disables, or pass an explicit
    # (lo, hi) tuple.
    y_clip: object = 'auto'


def _is_eq4(name: str) -> bool:
    return 'EQ_4' in name


def resolve_y_clip(y_clip, dataset_name: str):
    """'auto' -> the dataset's physical outcome range (tumor family:
    [0, TUMOUR_DEATH_THRESHOLD], the ground-truth clip range of
    cancer_simulation.py:502,702); EQ_4 -> None (its decay ODE cannot
    diverge and reference parity there is exact)."""
    if y_clip != 'auto':
        return y_clip
    if _is_eq4(dataset_name):
        return None
    from insite_tpu.sim.tumor import TUMOUR_DEATH_THRESHOLD
    return (0.0, float(TUMOUR_DEATH_THRESHOLD))


@partial(jax.jit, static_argnames=('library', 'joint', 'smooth', 'fd_order',
                                   'dt'))
def _eq4_design(vol_j, statics, arms01, eff_len, dt, library, joint,
                smooth, fd_order):
    """Single-dispatch EQ_4 design-matrix build: derivative estimate +
    feature tensor + sample masks in one dispatch instead of one per op."""
    if smooth:
        xdot = smoothed_finite_difference(vol_j, eff_len, dt, order=fd_order)
    else:
        xdot = finite_difference(vol_j, eff_len, dt, order=fd_order)
    sample_ok = (jnp.arange(vol_j.shape[1])[None, :] < eff_len[:, None])
    if joint:
        arms_in = jnp.broadcast_to(
            arms01[:, :1].astype(vol_j.dtype)[:, :, None],
            vol_j.shape + (1,))
        X = jnp.concatenate(
            [vol_j[..., None], arms_in,
             jnp.broadcast_to(statics[:, None, :],
                              vol_j.shape + (statics.shape[-1],))], axis=-1)
    else:
        X = jnp.concatenate(
            [vol_j[..., None],
             jnp.broadcast_to(statics[:, None, :],
                              vol_j.shape + (statics.shape[-1],))], axis=-1)
    theta = library(X)
    F = theta.shape[-1]
    arm0 = arms01[:, 0]
    return (theta.reshape(-1, F), xdot.reshape(-1), sample_ok.reshape(-1),
            jnp.broadcast_to(arm0[:, None], vol_j.shape).reshape(-1))


@partial(jax.jit, static_argnames=('library', 'joint', 'dt'))
def _tumor_design(vol_j, statics, arms_idx, lengths, library, joint, dt):
    """Single-dispatch tumor-family design build (FiniteDifference
    order=1 forward pairs within constant-treatment segments).

    Note on ``use_smoothed_finite_difference``: the reference's smoothed
    variant is SmoothedFiniteDifference(window_length=2, polyorder=1)
    (sindy.py:196-198) — a degree-1 fit through 2 points reproduces them
    exactly, so the smoother is the identity and both settings compute the
    same forward difference. We match that (the flag is honored by being
    a no-op, as in the reference)."""
    B, T = vol_j.shape
    xdot = (vol_j[:, 1:] - vol_j[:, :-1]) / dt
    sample_ok = (jnp.arange(T - 1)[None, :] < lengths[:, None])
    if joint:
        onehot = jax.nn.one_hot(arms_idx, 2, dtype=vol_j.dtype) \
            if arms_idx.ndim == 2 else arms_idx
        # joint tumor model uses the raw (chemo, radio) labels
        # (sindy.py:317-322)
        X = jnp.concatenate(
            [vol_j[:, :-1, None], onehot,
             jnp.broadcast_to(statics[:, None, :],
                              (B, T - 1, statics.shape[-1]))], axis=-1)
    else:
        X = jnp.concatenate(
            [vol_j[:, :-1, None],
             jnp.broadcast_to(statics[:, None, :],
                              (B, T - 1, statics.shape[-1]))], axis=-1)
    theta = library(X)
    F = theta.shape[-1]
    flat_arm = arms_idx.reshape(-1) if arms_idx.ndim == 2 else \
        jnp.zeros(B * (T - 1), jnp.int32)
    return (theta.reshape(-1, F), xdot.reshape(-1), sample_ok.reshape(-1),
            flat_arm)


class SINDyRegressor(CausalEstimator):
    model_type = 'sindy_regressor'
    tuning_criterion = 'rmse'

    def __init__(self, cfg: SINDyConfig, dataset_collection=None, mesh=None):
        self.cfg = cfg
        self.collection = dataset_collection
        self.mesh = mesh            # optional 1-D batch mesh for sharded eval
        self.dt = STANDARD_DT
        self.global_equation_string = ''
        self.coefs = None          # [A, F] global coefficients
        self.library: Optional[PolynomialLibrary] = None
        self.insite = cfg.insite
        if dataset_collection is not None and \
                not dataset_collection.processed_data_multi:
            dataset_collection.process_data_multi(
                include_continuous_treatment='EQ_5' in cfg.dataset_name)

    # ------------------------------------------------------------------
    # helpers

    @property
    def _n_arms(self) -> int:
        if self.cfg.joint_model:
            return 1
        return 2 if _is_eq4(self.cfg.dataset_name) else 4

    def _library_inputs(self, volumes, statics, arms_onehot=None):
        """Stack library inputs [y, (treatments if joint,) statics...].

        volumes: [..., T]; statics: [..., S]; returns [..., T, n_inputs].
        Matches the reference's feature_names ordering x0,u0,u1,...
        (sindy.py:278-322)."""
        parts = [volumes[..., None]]
        if self.cfg.joint_model and arms_onehot is not None:
            parts.append(arms_onehot)
        parts.append(jnp.broadcast_to(
            statics[..., None, :],
            volumes.shape + (statics.shape[-1],)))
        return jnp.concatenate(parts, axis=-1)

    def _unscaled_arrays(self, dataset):
        sp = dataset.scaling_params
        d = dataset.data
        dim_out = 1
        dim_static = d['static_features'].shape[-1]
        prev = np.squeeze(d['prev_outputs'], -1) * sp['output_stds'] \
            + sp['output_means']
        statics = d['static_features'] * \
            sp['inputs_stds'][dim_out:dim_out + dim_static] + \
            sp['input_means'][dim_out:dim_out + dim_static]
        treatments = d['current_treatments']
        if self.cfg.treatment_mode == 'multiclass':
            arms = np.argmax(treatments, axis=-1)
        else:
            arms = np.squeeze(treatments, -1).astype(np.int64) \
                if treatments.shape[-1] == 1 else treatments
        lengths = np.asarray(d['sequence_lengths']).astype(np.int64)
        return prev, statics, arms, lengths

    # ------------------------------------------------------------------
    # fitting

    def fit(self, train_f, val_f=None):
        t0 = time()
        cfg = self.cfg
        if cfg.joint_model and not _is_eq4(cfg.dataset_name):
            # ABLATION_ONE_ODE always runs multilabel (run.py:201): a
            # 4-valued multiclass arm index would be mangled by the 2-wide
            # one-hot joint features
            assert cfg.treatment_mode == 'multilabel', \
                'joint_model on tumor datasets requires multilabel treatments'
        prev, statics, arms, lengths = self._unscaled_arrays(train_f)
        d = train_f.data
        sp = train_f.scaling_params
        # reconstructed trajectory incl. final observation
        # (pkpd/utils.py:543-554)
        unscaled_outputs = np.squeeze(d['unscaled_outputs'], -1)
        volumes = np.concatenate([prev[:, :1], unscaled_outputs], axis=1)

        if _is_eq4(cfg.dataset_name):
            offset = 1          # sindy.py:149-159 sequence_lengths_offset
            fd_order, smooth = 4, True
        else:
            offset = 0
            fd_order, smooth = 1, cfg.use_smoothed_finite_difference

        n_inputs = 1 + statics.shape[-1] + \
            (arms.shape[-1] if cfg.joint_model and arms.ndim == 3 else
             (1 if cfg.joint_model else 0))
        degree_kw = (dict(degree=4, interaction_only=False)
                     if cfg.ablation_more_complex_basis_functions
                     else dict(degree=2, interaction_only=True))
        self.library = PolynomialLibrary(n_inputs=n_inputs, **degree_kw)

        if _is_eq4(cfg.dataset_name):
            coefs = self._fit_eq4(volumes, statics, arms, lengths, offset,
                                  fd_order, smooth)
        else:
            coefs = self._fit_tumor(volumes, statics, arms, lengths)
        self.coefs = np.asarray(coefs)
        if cfg.sindy_quantize:
            # the reference quantizes the sympy model PREDICTIONS run on
            # (sindy.py:274-294 + pkpd/utils.py:372-397), not just the
            # printed equation — round the global coefficients themselves,
            # so rollouts and the INSITE fine-tune start (and its proximal
            # anchor) all consume the quantized model
            self.coefs = np.round(
                self.coefs, cfg.sindy_quantize_global_model_round_to)

        names = self._input_names()
        eq_strs = [self.library.pretty_equation(
            self.coefs[a], names,
            quantize_round_to=(cfg.sindy_quantize_global_model_round_to
                               if cfg.sindy_quantize else None))
            for a in range(self.coefs.shape[0])]
        if cfg.joint_model:
            self.global_equation_string = f'Joint Model: x_dot = {eq_strs[0]}'
        else:
            self.global_equation_string = ' | '.join(
                f'Treatment {a}: x_dot = {s}' for a, s in enumerate(eq_strs))
        self.fit_seconds = time() - t0
        return self

    def _input_names(self):
        n_controls = self.library.n_inputs - 1
        return ['x0'] + [f'u{i}' for i in range(n_controls)]

    def _fit_eq4(self, volumes, statics, arms, lengths, offset, fd_order,
                 smooth):
        """EQ_4: each patient is one constant-arm trajectory of length
        seq_len - offset (pkpd/utils.py:419-432)."""
        cfg = self.cfg
        vol_j = jnp.asarray(volumes)
        eff_len = jnp.asarray(np.maximum(lengths - offset, 2))
        if cfg.wsindy:
            return self._fit_weak(vol_j, jnp.asarray(statics),
                                  jnp.asarray(arms), eff_len,
                                  fd_order=fd_order, smooth=smooth)

        flat_theta, flat_y, flat_ok, flat_arm = _eq4_design(
            vol_j, jnp.asarray(statics), jnp.asarray(arms), eff_len,
            self.dt, library=self.library, joint=cfg.joint_model,
            smooth=smooth, fd_order=fd_order)

        coefs = []
        for a in range(self._n_arms):
            w = flat_ok & ((flat_arm == a) if not cfg.joint_model else True)
            c, _ = stlsq_hostsolve(flat_theta, flat_y, cfg.sindy_threshold,
                                   cfg.sindy_alpha, sample_weight=w,
                                   max_iter=cfg.max_stlsq_iter)
            coefs.append(jnp.asarray(c, flat_theta.dtype))
        return jnp.stack(coefs)

    def _fit_tumor(self, volumes, statics, arms, lengths):
        """cancer_sim / EQ_5: trajectories are maximal constant-treatment
        segments; the segment's samples (including its closing transition
        step) train that arm's equation (pkpd/utils.py:433-462).

        Vectorised: a sample at step j belongs to arm[j]'s system whenever
        j < seq_len; forward difference (FiniteDifference order=1) pairs
        (x_j, x_{j+1}) within the same arm segment.  The reference's
        duplicated boundary element reproduces exactly this pairing.
        """
        cfg = self.cfg
        if cfg.wsindy:
            return self._fit_weak_tumor(volumes, statics, arms, lengths)

        flat_theta, flat_y, flat_ok, flat_arm = _tumor_design(
            jnp.asarray(volumes), jnp.asarray(statics), jnp.asarray(arms),
            jnp.asarray(lengths), library=self.library,
            joint=cfg.joint_model, dt=self.dt)

        coefs = []
        for a in range(self._n_arms):
            w = flat_ok if cfg.joint_model else \
                (flat_ok & (flat_arm == a))
            c, _ = stlsq_hostsolve(flat_theta, flat_y, cfg.sindy_threshold,
                                   cfg.sindy_alpha, sample_weight=w,
                                   max_iter=cfg.max_stlsq_iter)
            coefs.append(jnp.asarray(c, flat_theta.dtype))
        return jnp.stack(coefs)

    def _wsindy_grid(self):
        """(thresholds [G], paired alphas [G]) for the candidate grid."""
        cfg = self.cfg
        if cfg.wsindy_select:
            ths = np.asarray(cfg.wsindy_threshold_grid, float) * \
                cfg.sindy_threshold
            als = np.asarray(cfg.wsindy_alpha_grid, float)
            return np.repeat(ths, len(als)), np.tile(als, len(ths))
        return np.asarray([cfg.sindy_threshold]), np.asarray([0.5])

    def _weak_solve_arms(self, systems_np, grid, alphas, theta_np, y_np,
                         ok_np, armf_np):
        """Host-f64 per-arm candidate solves + strong-form selection
        (shared by the EQ_4 and tumor weak paths)."""
        from insite_tpu.discovery.wsindy import (weak_stlsq_host,
                                                 weak_select_host)
        cfg = self.cfg
        coefs = []
        for a in range(self._n_arms):
            A, b, w = systems_np[a]
            cands = np.stack([weak_stlsq_host(A, b, w, t, alpha=al)
                              for t, al in zip(grid, alphas)])
            if len(grid) == 1:
                coefs.append(cands[0])
                continue
            wa = (ok_np & ((armf_np == a) if not cfg.joint_model
                           else True)).astype(np.float64)
            c, _ = weak_select_host(cands, grid, theta_np, y_np, wa,
                                    select_tol=cfg.wsindy_select_tol)
            coefs.append(c)
        return coefs

    def _fit_weak(self, volumes, statics, arms, eff_len, fd_order=4,
                  smooth=True):
        """Weak-form discovery, solved on host in f64 (the weak normal
        equations are beyond f32 — discovery/wsindy.py::weak_stlsq_host),
        with threshold-grid model selection scored on the strong-form
        training residual (wsindy_select)."""
        from insite_tpu.discovery.wsindy import weak_system
        cfg = self.cfg
        arm0 = arms[:, 0]
        grid, alphas = self._wsindy_grid()
        # device: weak systems for every arm + the strong-form scoring
        # design, pulled in ONE batched device_get
        flat_theta, flat_y, flat_ok, flat_arm = _eq4_design(
            volumes, statics, arms, eff_len, self.dt,
            library=self.library, joint=cfg.joint_model, smooth=smooth,
            fd_order=fd_order)
        systems = []
        for a in range(self._n_arms):
            sel = None if cfg.joint_model else (arm0 == a)
            systems.append(weak_system(volumes, statics, eff_len,
                                       self.library, self.dt,
                                       trajectory_mask=sel))
        host = jax.device_get((systems, flat_theta, flat_y, flat_ok,
                               flat_arm))
        systems_np, theta_np, y_np, ok_np, armf_np = host
        coefs = self._weak_solve_arms(systems_np, grid, alphas, theta_np,
                                      y_np, ok_np, armf_np)
        return jnp.asarray(np.stack(coefs), volumes.dtype)

    def _fit_weak_tumor(self, volumes, statics, arms, lengths):
        """Weak-form discovery on the tumor family (cancer_sim / EQ_5),
        beyond the reference (its run.py:100-103 skips wsindy off EQ_4):
        multi-scale all-starts windows constrained to constant-treatment
        segments (discovery/wsindy.py::weak_system_segments), host-f64
        solves, candidates scored on the strong-form tumor design."""
        cfg = self.cfg
        assert not cfg.joint_model, \
            'wsindy joint model is EQ_4-only (the joint tumor library ' \
            'takes time-varying treatment inputs, which the weak ' \
            'integrand does not thread)'
        from insite_tpu.discovery.wsindy import weak_system_segments
        vol_j = jnp.asarray(volumes)
        statics_j = jnp.asarray(statics)
        arms_j = jnp.asarray(arms)                       # [B, T-1] arm idx
        lengths_j = jnp.asarray(lengths)
        grid, alphas = self._wsindy_grid()
        flat_theta, flat_y, flat_ok, flat_arm = _tumor_design(
            vol_j, statics_j, arms_j, lengths_j, library=self.library,
            joint=False, dt=self.dt)
        # `lengths` transitions pair lengths+1 valid volume points
        systems = [weak_system_segments(
            vol_j, statics_j, lengths_j + 1, self.library, self.dt,
            arms_j, a, window_lens=cfg.wsindy_tumor_window_lens)
            for a in range(self._n_arms)]
        host = jax.device_get((systems, flat_theta, flat_y, flat_ok,
                               flat_arm))
        systems_np, theta_np, y_np, ok_np, armf_np = host
        coefs = self._weak_solve_arms(systems_np, grid, alphas, theta_np,
                                      y_np, ok_np, armf_np)
        return jnp.asarray(np.stack(coefs), volumes.dtype)

    # ------------------------------------------------------------------
    # prediction

    def get_predictions(self, dataset) -> np.ndarray:
        if not self.insite:
            preds = self._global_rollout(dataset)
        else:
            preds = self._fine_tuned_rollout(dataset, projection_horizon=1)
        preds = jax.device_get(preds)
        assert not np.any(np.isnan(preds)), 'Predictions contain NaN'
        return preds

    def get_autoregressive_predictions(self, dataset) -> np.ndarray:
        ph = self.cfg.projection_horizon
        if not self.insite:
            preds = self._global_rollout(dataset)
        else:
            preds = self._fine_tuned_rollout(dataset, projection_horizon=ph)
        preds = jax.device_get(preds)
        lengths = np.asarray(dataset.data['sequence_lengths']).astype(int)
        lower = np.maximum(1, lengths - ph)
        win = lower[:, None] + np.arange(ph)[None, :]
        return preds[np.arange(preds.shape[0])[:, None], win]

    def _rollout_args(self, dataset):
        prev, statics, arms, lengths = self._unscaled_arrays(dataset)
        args = (jnp.asarray(prev), jnp.asarray(statics), jnp.asarray(arms),
                jnp.asarray(lengths))
        if self.mesh is not None:
            from insite_tpu.parallel import shard_rows
            args, self._n_rows = shard_rows(args, self.mesh)
        else:
            self._n_rows = args[0].shape[0]
        return args

    def _use_pallas(self):
        mode = self.cfg.rollout_backend
        if mode == 'xla' or self.cfg.joint_model or self.mesh is not None:
            return False
        if mode == 'pallas':
            return True
        from insite_tpu.ops import kernels_default
        return kernels_default()

    def _y_clip(self):
        return resolve_y_clip(self.cfg.y_clip, self.cfg.dataset_name)

    def _global_rollout(self, dataset):
        prev, statics, arms, lengths = self._rollout_args(dataset)
        coefs = jnp.asarray(self.coefs)
        if self._use_pallas():
            from insite_tpu.ops import pallas_batched_rollout
            preds = pallas_batched_rollout(
                self.library, coefs[None], prev[:, 0], statics, arms,
                self.dt, y_clip=self._y_clip())[:self._n_rows]
        else:
            preds = batched_rollout(self.library, coefs[None], prev[:, 0],
                                    statics, arms, self.dt,
                                    joint=self.cfg.joint_model,
                                    shared_coefs=True,
                                    y_clip=self._y_clip())[:self._n_rows]
        # zero past-valid-length positions (can be inf on divergence; no
        # metric reads them but inf * 0 masks would produce NaN)
        valid = jnp.arange(preds.shape[1])[None, :] < \
            lengths[:preds.shape[0], None]
        preds = jnp.where(valid, preds, 0.0)
        sp = dataset.scaling_params
        return ((preds - sp['output_means']) / sp['output_stds'])[..., None]

    def _fine_tune(self, dataset, projection_horizon: int):
        """Run the per-patient fine-tune; returns (preds [B, T],
        per-patient coefs [B, A, F]).

        Large cohorts are optionally processed in fixed-size row chunks
        (cfg.finetune_chunk): the fine-tune Jacobian carries A*F forward
        tangents per row, and with the degree-4 ablation library one
        whole-test-set dispatch exhausted a 16 GiB device.
        The last chunk is padded by repeating its final row — the
        reference's pmap shard padding trick (sindy.py:810-841) — so every
        chunk reuses one compiled shape."""
        cfg = self.cfg
        prev, statics, arms, lengths = self._rollout_args(dataset)
        if cfg.smooth_input_data:
            from insite_tpu.discovery.differentiate import savgol_smooth
            prev = savgol_smooth(prev, lengths)
        coefs = jnp.asarray(self.coefs)

        # the sparse support is host-known here (self.coefs is a fitted
        # numpy array), so the GN problem can be reduced to the active
        # coordinates — far fewer jacfwd tangents per row
        active_idx = tuple(
            int(i) for i in
            np.flatnonzero(np.abs(np.asarray(self.coefs)).reshape(-1)
                           > 1e-3))

        def solve(prev_c, statics_c, arms_c, lengths_c):
            if cfg.insite_solver == 'gauss_newton':
                if self._use_pallas() and active_idx:
                    # one fused rollout+sensitivity kernel per LM
                    # iteration instead of jvp-through-scan
                    return insite_gn_finetune_predict_pallas(
                        self.library, coefs, prev_c, statics_c, arms_c,
                        lengths_c, self.dt, lam=cfg.lam,
                        projection_horizon=projection_horizon,
                        gn_iters=cfg.gn_iters, y_clip=self._y_clip(),
                        active_idx=active_idx)
                return insite_gn_finetune_predict(
                    self.library, coefs, prev_c, statics_c, arms_c,
                    lengths_c, self.dt, lam=cfg.lam,
                    projection_horizon=projection_horizon,
                    joint=cfg.joint_model, gn_iters=cfg.gn_iters,
                    y_clip=self._y_clip(), active_idx=active_idx)
            return insite_finetune_predict(
                self.library, coefs, prev_c, statics_c, arms_c, lengths_c,
                self.dt, lam=cfg.lam, projection_horizon=projection_horizon,
                joint=cfg.joint_model, bfgs_tol=cfg.bfgs_tol,
                bfgs_maxiter=cfg.bfgs_maxiter, y_clip=self._y_clip())

        chunk = cfg.finetune_chunk
        if chunk is None and cfg.ablation_more_complex_basis_functions:
            chunk = 2048
        n = prev.shape[0]
        if not chunk or n <= chunk:
            return solve(prev, statics, arms, lengths)
        if self.mesh is not None:
            # row-chunked fine-tune composed with the mesh: each chunk is
            # a host slice padded to the (mesh-multiple) chunk size and
            # re-sharded over the batch axis, so the A*F-tangent Jacobian
            # memory bound of the degree-4 library holds PER DEVICE while
            # every device works on every chunk. The inputs are tiny
            # ([rows, T]); only the fine-tune program's transient Jacobian
            # is large, so per-chunk host->device placement is cheap.
            from insite_tpu.parallel import shard_rows
            ndev = self.mesh.devices.size
            chunk = -(-chunk // ndev) * ndev
            hp, hs, ha, hl = [np.asarray(a) for a in
                              jax.device_get((prev, statics, arms,
                                              lengths))]
            preds_l, coefs_l = [], []
            for i in range(0, n, chunk):
                take = min(chunk, n - i)

                def padded(x):
                    xs = x[i:i + take]
                    if take < chunk:
                        xs = np.concatenate(
                            [xs, np.repeat(xs[-1:], chunk - take, axis=0)])
                    return xs

                args_c, _ = shard_rows(
                    (padded(hp), padded(hs), padded(ha), padded(hl)),
                    self.mesh)
                p, c = solve(*args_c)
                preds_l.append(p[:take])
                coefs_l.append(c[:take])
            return jnp.concatenate(preds_l), jnp.concatenate(coefs_l)
        preds_l, coefs_l = [], []
        for i in range(0, n, chunk):
            take = min(chunk, n - i)
            pad = chunk - take

            def padded(x):
                xs = x[i:i + take]
                if pad:
                    xs = jnp.concatenate(
                        [xs, jnp.repeat(xs[-1:], pad, axis=0)])
                return xs

            p, c = solve(padded(prev), padded(statics), padded(arms),
                         padded(lengths))
            preds_l.append(p[:take])
            coefs_l.append(c[:take])
        # results stay on device; callers device_get once at the end
        return jnp.concatenate(preds_l), jnp.concatenate(coefs_l)

    def get_fine_tuned_coefficients(self, dataset,
                                    projection_horizon: int = 1):
        """Per-patient fine-tuned coefficient array [B, A, F] — the
        recovered parametric distribution of individual ODE parameters
        (the INSIGHT_RECOVER_PARAMETRIC_DIST experiment; the reference only
        debug-printed these, sindy.py:679-683)."""
        _, coefs = self._fine_tune(dataset, projection_horizon)
        return jax.device_get(coefs)[:self._n_rows]

    def _fine_tuned_rollout(self, dataset, projection_horizon: int):
        preds, _ = self._fine_tune(dataset, projection_horizon)
        preds = preds[:self._n_rows]
        # positions past each row's valid length are never read by any
        # metric but can be inf (autoregressive divergence under 0-padded
        # arms) — zero them so the NaN/Inf guard checks only real entries
        lengths = np.asarray(dataset.data['sequence_lengths']).astype(int)
        valid = jnp.arange(preds.shape[1])[None, :] < \
            jnp.asarray(lengths)[:preds.shape[0], None]
        preds = jnp.where(valid, preds, 0.0)
        sp = dataset.scaling_params
        preds = (preds - sp['output_means']) / sp['output_stds']
        preds = jax.device_get(preds)[..., None]
        assert not np.any(np.isnan(preds) | np.isinf(preds))
        return preds


# ---------------------------------------------------------------------------
# pure rollout / fine-tuning kernels


def _dy(library, coefs_sel, y, statics, arm_onehot, joint):
    """Vector field of the discovered model: Theta([y, u]) . c, batched.

    y: [B]; statics: [B, S]; coefs_sel: [B, F] (already arm-selected);
    arm_onehot: [B, A_in] treatment inputs for the joint model."""
    parts = [y[..., None]]
    if joint and arm_onehot is not None:
        parts.append(arm_onehot)
    parts.append(statics)
    X = jnp.concatenate(parts, axis=-1)
    theta = library(X)                         # [B, F]
    return jnp.sum(theta * coefs_sel, axis=-1)


@partial(jax.jit, static_argnames=('library', 'joint', 'shared_coefs',
                                   'y_clip'))
def batched_rollout(library, coefs, y0, statics, arms, dt, joint=False,
                    shared_coefs=False, y_clip=None):
    """Autoregressive Euler rollout of the discovered model over the whole
    batch: returns [B, T] predictions of y[1..T].

    coefs: [1, A, F] (shared_coefs) or [B, A, F] per-row fine-tuned.
    arms: [B, T] integer arm per step (multiclass) or [B, T, A_in] labels
    (joint/multilabel).
    y_clip: optional (lo, hi) — project the state onto the outcome's
    physical range after every step.  The tumor-family simulators clip the
    ground-truth volume to [0, TUMOUR_DEATH_THRESHOLD] at every step
    (cancer_simulation.py:502,702), so the prediction target is bounded by
    construction; clipping the rollout to the same set is a pure
    improvement and keeps f32 free-runs from diverging on extreme cohorts.
    """
    B = y0.shape[0]
    coefs_b = jnp.broadcast_to(coefs, (B,) + coefs.shape[1:]) \
        if shared_coefs else coefs

    def step(y, arm_t):
        if joint:
            c = coefs_b[:, 0, :]
            onehot = arm_t.astype(y.dtype)
            if onehot.ndim == 1:
                onehot = onehot[:, None]
        else:
            c = jnp.take_along_axis(
                coefs_b, arm_t[:, None, None].astype(jnp.int32),
                axis=1)[:, 0, :]
            onehot = None
        h = dt / STEPS_FOR_DT
        for _ in range(STEPS_FOR_DT):
            y = y + _dy(library, c, y, statics, onehot, joint) * h
        if y_clip is not None:
            y = jnp.clip(y, y_clip[0], y_clip[1])
        return y, y

    arms_t = jnp.moveaxis(arms, 1, 0)          # scan over time axis
    _, ys = lax.scan(step, y0, arms_t)
    return jnp.moveaxis(ys, 0, 1)              # [B, T]


@partial(jax.jit,
         static_argnames=('library', 'projection_horizon', 'joint',
                          'bfgs_maxiter', 'y_clip'))
def insite_finetune_predict(library, global_coefs, prev, statics, arms,
                            lengths, dt, lam, projection_horizon: int,
                            joint=False, bfgs_tol=1e-12, bfgs_maxiter=None,
                            y_clip=None):
    """INSITE: per-row BFGS fine-tuning of the sparsity-masked coefficients,
    then rollout with the personalised model (sindy.py:569-715).

    Objective (f_to_min_func, sindy.py:781-794):
        mse_prefix / (2.5 * mse_prefix@global) + lam * mean((c - c_g)^2)
    where the prefix mask covers the first (seq_len - projection_horizon)
    steps.  Rows with seq_len <= projection_horizon skip fine-tuning
    (lax.cond at sindy.py:571-574); a failed line search falls back to the
    global coefficients (res.status == 3 branch, sindy.py:628-631).
    """
    A, F = global_coefs.shape
    sparse_mask = (jnp.abs(global_coefs) > 1e-3).astype(prev.dtype)
    g_flat = global_coefs.reshape(-1)
    T = prev.shape[1]

    def row_objective_factory(prev_i, statics_i, arms_i, length_i):
        prefix_mask = (jnp.arange(T - 1) <
                       (length_i - projection_horizon)).astype(prev_i.dtype)

        def rollout(coefs_af):
            return batched_rollout(
                library, coefs_af[None], prev_i[None, 0], statics_i[None],
                arms_i[None], dt, joint=joint, shared_coefs=True,
                y_clip=y_clip)[0]

        def prefix_mse(coefs_flat):
            c = (coefs_flat.reshape(A, F)) * sparse_mask
            preds = rollout(c)
            # where() before squaring: a diverging rollout can be inf at
            # masked positions, and inf * 0 = NaN would poison the sum
            err = jnp.where(prefix_mask > 0, prev_i[1:] - preds[:-1], 0.0)
            return jnp.sum(err * err) / jnp.maximum(jnp.sum(prefix_mask),
                                                    1.0)

        return rollout, prefix_mse

    def finetune_row(prev_i, statics_i, arms_i, length_i):
        rollout, prefix_mse = row_objective_factory(prev_i, statics_i,
                                                    arms_i, length_i)
        mse0 = prefix_mse(g_flat)
        # guard: a perfectly-fit prefix (mse0 == 0) must not NaN the
        # objective (the GN path guards identically)
        norm_const = jnp.maximum(mse0 * 2.5, 1e-30)

        def objective(coefs_flat):
            reg = lam * jnp.mean((g_flat - coefs_flat) ** 2)
            return prefix_mse(coefs_flat) / norm_const + reg

        def do_finetune(_):
            opts = {} if bfgs_maxiter is None else {'maxiter': bfgs_maxiter}
            res = minimize(objective, g_flat, method='BFGS', tol=bfgs_tol,
                           options=opts)
            c = jnp.where(res.status == 3, g_flat, res.x)
            return c.reshape(A, F) * sparse_mask

        coefs_i = lax.cond(length_i <= projection_horizon,
                           lambda _: global_coefs, do_finetune, operand=None)
        return rollout(coefs_i), coefs_i

    return jax.vmap(finetune_row)(prev, statics, arms, lengths)


@partial(jax.jit,
         static_argnames=('library', 'projection_horizon', 'joint',
                          'gn_iters', 'y_clip', 'active_idx'))
def insite_gn_finetune_predict(library, global_coefs, prev, statics, arms,
                               lengths, dt, lam, projection_horizon: int,
                               joint=False, gn_iters: int = 12,
                               y_clip=None, active_idx=None):
    """INSITE fine-tuning by damped Gauss-Newton instead of BFGS.

    Minimises the identical objective (f_to_min_func, sindy.py:781-794)

        prefix_mse(c) / (2.5 * prefix_mse(c_global)) + lam * mean((c - g)^2)

    written as a nonlinear least-squares problem: data residuals are the
    masked one-step rollout errors scaled by 1/sqrt(2.5*mse0*n), penalty
    residuals sqrt(lam/K)*(c - g).  Each iteration builds the per-patient
    Jacobian with jacfwd (K<=~20 tangents, one batched rollout each — no
    line search, no lock-stepped zoom) and solves the K x K damped normal
    equations, with a Levenberg-Marquardt trust parameter per patient.

    Semantics preserved from the BFGS path: rows with
    seq_len <= projection_horizon keep the global coefficients; a candidate
    step is only accepted if it lowers the objective (the reference's
    failed-line-search fallback becomes per-step rejection, so a patient
    that never improves rolls out the global model exactly).
    """
    A, F = global_coefs.shape
    K = A * F
    sparse_mask = (jnp.abs(global_coefs) > 1e-3).astype(prev.dtype)
    g_flat = global_coefs.reshape(-1)
    T = prev.shape[1]
    # active-set reduction: when the caller knows the sparse support
    # host-side (a static tuple of flat indices with |coef| > 1e-3), the
    # Gauss-Newton problem shrinks from K = A*F coordinates to the 2-8
    # active ones — jacfwd carries that many fewer forward tangents.
    # Inactive coordinates of the full-K problem never move (their only
    # residual is the proximal term, which starts at zero), so the reduced
    # problem is exactly equivalent.
    if active_idx is not None and len(active_idx) > 0:
        act = jnp.asarray(active_idx, jnp.int32)

        def to_full(c_red):
            return jnp.zeros(K, prev.dtype).at[act].set(c_red)

        g_red = g_flat[act]
    else:
        def to_full(c_red):
            return c_red

        g_red = g_flat
    Kr = g_red.shape[0]
    eye = jnp.eye(Kr, dtype=prev.dtype)

    def finetune_row(prev_i, statics_i, arms_i, length_i):
        prefix_mask = (jnp.arange(T - 1) <
                       (length_i - projection_horizon)).astype(prev_i.dtype)
        n_mask = jnp.maximum(jnp.sum(prefix_mask), 1.0)

        def rollout(coefs_af):
            return batched_rollout(
                library, coefs_af[None], prev_i[None, 0], statics_i[None],
                arms_i[None], dt, joint=joint, shared_coefs=True,
                y_clip=y_clip)[0]

        def data_residuals(coefs_red):
            c = to_full(coefs_red).reshape(A, F) * sparse_mask
            preds = rollout(c)
            # where(), not multiply: inf preds at masked positions would
            # turn inf * 0 into NaN residuals
            return jnp.where(prefix_mask > 0, prev_i[1:] - preds[:-1], 0.0)

        def resid_and_jac(coefs_red):
            """Unscaled data residuals + their Jacobian in ONE rollout
            scan: vmapped jvp over the coordinate basis carries the Kr
            forward tangents alongside the (unbatched, computed-once)
            primal — the wall-clock of this whole fine-tune is sequential
            rollout depth, so every saved scan is ~T*STEPS_FOR_DT steps."""
            r, Jt = jax.vmap(
                lambda v: jax.jvp(data_residuals, (coefs_red,), (v,)),
                out_axes=(None, 0))(eye)
            return r, Jt.T                                   # [T-1], [T-1,Kr]

        reg_scale = jnp.sqrt(lam / K)

        def do_finetune(_):
            r0, J0 = resid_and_jac(g_red)
            mse0 = jnp.sum(r0 ** 2) / n_mask
            # scale so that sum(residuals^2) == objective (guard mse0 ~ 0)
            ds = 1.0 / jnp.sqrt(2.5 * jnp.maximum(mse0, 1e-30) * n_mask)

            def full_obj(r_data, c):
                return jnp.sum((r_data * ds) ** 2) + \
                    jnp.sum((reg_scale * (c - g_red)) ** 2)

            def solve_step(r_data, J_data, c, mu):
                Js = J_data * ds                             # [T-1, Kr]
                # f32 products default to TF32 on the GPU: keep them exact
                JtJ = jnp.matmul(Js.T, Js, precision='highest') + \
                    (reg_scale ** 2) * eye
                rhs = -jnp.matmul(Js.T, r_data * ds, precision='highest') \
                    - (reg_scale ** 2) * (c - g_red)
                return c + jnp.linalg.solve(JtJ + mu * eye, rhs)

            mu0 = jnp.asarray(1e-3, prev_i.dtype)
            obj0 = full_obj(r0, g_red)
            cand0 = solve_step(r0, J0, g_red, mu0)

            def gn_step(carry, _):
                # deferred acceptance: ONE rollout scan per iteration —
                # evaluate the pending candidate, fall back to the cached
                # (r, J) of the incumbent on rejection, propose the next
                c_best, r_best, J_best, obj_best, mu, cand = carry
                r_c, J_c = resid_and_jac(cand)
                obj_c = full_obj(r_c, cand)
                better = jnp.isfinite(obj_c) & (obj_c < obj_best)
                c_best = jnp.where(better, cand, c_best)
                obj_best = jnp.where(better, obj_c, obj_best)
                r_best = jnp.where(better, r_c, r_best)
                J_best = jnp.where(better, J_c, J_best)
                mu = jnp.clip(jnp.where(better, mu * 0.3, mu * 10.0),
                              1e-8, 1e8)
                cand = solve_step(r_best, J_best, c_best, mu)
                return (c_best, r_best, J_best, obj_best, mu, cand), None

            init = (g_red, r0, J0, obj0, mu0, cand0)
            (c, *_), _ = lax.scan(gn_step, init, None, length=gn_iters)
            return to_full(c).reshape(A, F) * sparse_mask

        coefs_i = lax.cond(length_i <= projection_horizon,
                           lambda _: global_coefs, do_finetune, operand=None)
        return rollout(coefs_i), coefs_i

    return jax.vmap(finetune_row)(prev, statics, arms, lengths)


@partial(jax.jit,
         static_argnames=('library', 'dt', 'projection_horizon', 'gn_iters',
                          'y_clip', 'active_idx', 'interpret'))
def insite_gn_finetune_predict_pallas(library, global_coefs, prev, statics,
                                      arms, lengths, dt, lam,
                                      projection_horizon: int,
                                      gn_iters: int = 12, y_clip=None,
                                      active_idx=(), interpret=False):
    """The Gauss-Newton INSITE fine-tune with the rollout + Jacobian of
    every LM iteration computed by ONE Pallas kernel call
    (`ops.pallas_rollout_with_sens` integrates the forward-sensitivity ODE
    alongside the state).  Identical objective and deferred-acceptance
    update sequence as `insite_gn_finetune_predict`; the per-row
    skip/fallback semantics (rows with seq_len <= projection_horizon keep
    the global model) are applied as batch masks.

    gn_iters kernel calls + batched [B, Kr, Kr] solves replace XLA's
    jvp-through-scan (hundreds of tiny sequential kernels per iteration).
    """
    from insite_tpu.ops.pallas_rollout import (pallas_batched_rollout,
                                               pallas_rollout_with_sens)
    A, F = global_coefs.shape
    K = A * F
    assert len(active_idx) > 0
    act = jnp.asarray(active_idx, jnp.int32)
    Kr = len(active_idx)
    B, T = prev.shape
    dtype = prev.dtype
    sparse_flat = (jnp.abs(global_coefs) > 1e-3).astype(dtype).reshape(-1)
    g_red = global_coefs.reshape(-1)[act]

    ph = projection_horizon
    prefix_mask = (jnp.arange(T - 1)[None, :] <
                   (lengths - ph)[:, None]).astype(dtype)       # [B, T-1]
    n_mask = jnp.maximum(prefix_mask.sum(1), 1.0)               # [B]
    skip = (lengths <= ph)                                      # [B]
    eye = jnp.eye(Kr, dtype=dtype)
    reg2 = lam / K                                              # reg_scale^2

    def to_full(c_red):                                         # [B, Kr]
        c = jnp.zeros((B, K), dtype).at[:, act].set(c_red)
        return (c * sparse_flat[None, :]).reshape(B, A, F)

    def resid_jac(c_red):
        y, s = pallas_rollout_with_sens(
            library, to_full(c_red), prev[:, 0], statics, arms, dt,
            tuple(active_idx), y_clip=y_clip, interpret=interpret)
        r = jnp.where(prefix_mask > 0, prev[:, 1:] - y[:, :-1], 0.0)
        J = jnp.where(prefix_mask[..., None] > 0, -s[:, :-1, :], 0.0)
        return r, J

    r0, J0 = resid_jac(jnp.broadcast_to(g_red, (B, Kr)))
    mse0 = (r0 ** 2).sum(1) / n_mask
    ds = 1.0 / jnp.sqrt(2.5 * jnp.maximum(mse0, 1e-30) * n_mask)   # [B]

    def full_obj(r, c):
        return ((r * ds[:, None]) ** 2).sum(1) + \
            reg2 * ((c - g_red[None, :]) ** 2).sum(1)

    def solve_step(r, J, c, mu):
        Js = J * ds[:, None, None]
        JtJ = jnp.einsum('btj,btk->bjk', Js, Js,
                         precision='highest') + reg2 * eye[None]
        rhs = -jnp.einsum('btj,bt->bj', Js, r * ds[:, None],
                          precision='highest') \
            - reg2 * (c - g_red[None, :])
        delta = jnp.linalg.solve(JtJ + mu[:, None, None] * eye[None],
                                 rhs[..., None])[..., 0]
        return c + delta

    c_best = jnp.broadcast_to(g_red, (B, Kr))
    r_best, J_best = r0, J0
    obj_best = full_obj(r0, c_best)
    mu = jnp.full((B,), 1e-3, dtype)
    cand = solve_step(r_best, J_best, c_best, mu)
    for _ in range(gn_iters):
        r_c, J_c = resid_jac(cand)
        obj_c = full_obj(r_c, cand)
        better = jnp.isfinite(obj_c) & (obj_c < obj_best)
        c_best = jnp.where(better[:, None], cand, c_best)
        obj_best = jnp.where(better, obj_c, obj_best)
        r_best = jnp.where(better[:, None], r_c, r_best)
        J_best = jnp.where(better[:, None, None], J_c, J_best)
        mu = jnp.clip(jnp.where(better, mu * 0.3, mu * 10.0), 1e-8, 1e8)
        cand = solve_step(r_best, J_best, c_best, mu)

    coefs = jnp.where(skip[:, None], g_red[None, :], c_best)
    coefs_full = to_full(coefs)
    # skip rows must roll out the FULL unmasked global model to match the
    # XLA path's lax.cond skip branch exactly (to_full drops |coef|<=1e-3
    # entries, a divergence whenever the global fit retains sub-threshold
    # coefficients)
    coefs_full = jnp.where(skip[:, None, None],
                           global_coefs[None].astype(dtype), coefs_full)
    preds = pallas_batched_rollout(library, coefs_full, prev[:, 0], statics,
                                   arms, dt, y_clip=y_clip,
                                   interpret=interpret)
    return preds, coefs_full
