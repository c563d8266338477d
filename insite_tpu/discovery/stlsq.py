"""Sequentially-thresholded least squares (STLSQ) as fixed-iteration masked
ridge in pure JAX — the discovery optimizer replacing pysindy's
STLSQ/LSQIntialMask (reference semantics: pkpd/utils.py:96-335 and pysindy's
SINDyOptimizer unbias step).

Design: the support set is a boolean mask updated by thresholding; each
iteration solves the masked ridge normal equations.  Masked columns get a
unit diagonal and zero RHS, so their coefficients are exactly zero while the
system stays full-rank and static-shape — jit/vmap-friendly, which makes the
per-trajectory "individualised equations" path a single batched solve.

The iteration is a fixed point once the mask stabilises (identical ridge
solution -> identical mask), so running a fixed ``max_iter`` reproduces the
reference's converge-or-break loop (pkpd/utils.py:274-310) without
data-dependent control flow.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


def _masked_solve(gram, rhs, mask, alpha):
    """Solve (Θ'Θ + αI) c = Θ'y restricted to ``mask`` columns."""
    m = mask.astype(gram.dtype)
    A = gram * jnp.outer(m, m)
    A = A + jnp.diag(alpha * m + (1.0 - m))
    b = rhs * m
    return jnp.linalg.solve(A, b)


@partial(jax.jit, static_argnames=('max_iter',))
def stlsq(theta, y, threshold, alpha, sample_weight=None, max_iter: int = 20,
          initial_mask=None, unbias: bool = True):
    """STLSQ with optional unbiasing OLS refit on the final support.

    theta: [N, F] feature matrix; y: [N] target; sample_weight: [N] 0/1 mask
    for padded rows (masked accumulation keeps ragged cohorts static-shape).
    Returns (coefs [F], support mask [F]).

    Matches pysindy STLSQ(threshold, alpha, ridge) + SINDyOptimizer(unbias)
    used at sindy.py:190-215; with ``initial_mask`` it matches the
    ``LSQIntialMask`` initial-guess variant (pkpd/utils.py:244-327).
    """
    dtype = theta.dtype
    # precision='highest': f32 matmuls default to TF32 on the GPU — the gram
    # accumulation over ~60k rows needs true f32 or the near-collinear
    # static columns of the polynomial library wash out
    if sample_weight is not None:
        w = sample_weight.astype(dtype)
        gram = jnp.einsum('nf,ng,n->fg', theta, theta, w,
                          precision='highest')
        rhs = jnp.einsum('nf,n->f', theta, y * w, precision='highest')
    else:
        gram = jnp.einsum('nf,ng->fg', theta, theta, precision='highest')
        rhs = jnp.einsum('nf,n->f', theta, y, precision='highest')

    F = theta.shape[-1]
    mask0 = (jnp.ones(F, bool) if initial_mask is None
             else jnp.asarray(initial_mask, bool))

    # relative ridge floor: gram entries scale with n * feature^2 (1e10 for
    # tumor volumes), so the reference's absolute alpha=0.5 is negligible
    # and an exactly-duplicate column pair (constant static == bias in
    # single-patient-type EQ_5_A) is singular at f32 -> NaN. The floor is
    # ~eps-relative: invisible on well-conditioned problems, lifesaving on
    # degenerate ones.
    rel = 1e-6 if dtype == jnp.float32 else 1e-12
    floor = (rel * jnp.trace(gram) / F).astype(dtype)
    alpha_eff = jnp.maximum(jnp.asarray(alpha, dtype), floor)

    def body(carry, _):
        mask, _ = carry
        c = _masked_solve(gram, rhs, mask, alpha_eff)
        new_mask = (jnp.abs(c) >= threshold) & mask
        # degenerate guard: if thresholding kills everything, keep zeros
        # (reference warns and zeroes out, pkpd/utils.py:275-281)
        c = jnp.where(new_mask, c, 0.0)
        return (new_mask, c), None

    (mask, coefs), _ = lax.scan(body, (mask0, jnp.zeros(F, dtype)),
                                None, length=max_iter)
    if unbias:
        ols = _masked_solve(gram, rhs, mask, floor)
        coefs = jnp.where(mask, ols, 0.0)
    return coefs, mask


@partial(jax.jit)
def _qr_reduce(theta, y, sample_weight):
    """Device-side reduction of the regression problem: QR of the weighted
    feature matrix.  Returns (R [F, F], Qᵀy [F]).

    This is the f32-robust path: forming ΘᵀΘ directly in f32 destroys the
    near-collinear directions of the polynomial library (u-columns of the
    EQ_4 statics are 0.5±0.05 — the '1'/'u0'/'u1'/'u0 u1' block is nearly
    rank one), while QR keeps the error at eps·cond(Θ).  The O(N·F²) work
    runs on the device; only the F×F triangle leaves it.
    """
    if sample_weight is not None:
        w = jnp.sqrt(sample_weight.astype(theta.dtype))
        theta = theta * w[:, None]
        y = y * w
    A = jnp.concatenate([theta, y[:, None]], axis=1)
    R = jnp.linalg.qr(A, mode='r')
    F = theta.shape[-1]
    return R[:F, :F], R[:F, F]


def stlsq_from_qr(R, qty, threshold, alpha, max_iter: int = 100,
                  initial_mask=None, unbias: bool = True):
    """The tiny F×F STLSQ thresholding iteration on a QR-reduced problem,
    run on the host in float64 — numerically equivalent to the reference's
    sklearn f64 path (pysindy STLSQ + unbias, pkpd/utils.py:96-335)
    regardless of the device compute dtype.  Takes the (R, Qᵀy) triangle of
    `_qr_reduce` (possibly fetched from a fused device program); returns
    numpy (coefs [F], mask [F])."""
    import numpy as np
    R = np.asarray(R, np.float64)
    qty = np.asarray(qty, np.float64)
    F = R.shape[0]
    gram = R.T @ R
    rhs = R.T @ qty

    def solve(mask, a):
        m = mask.astype(np.float64)
        A = gram * np.outer(m, m) + np.diag(a * m + (1.0 - m))
        return np.linalg.solve(A, rhs * m)

    mask = (np.ones(F, bool) if initial_mask is None
            else np.asarray(initial_mask, bool))
    coefs = np.zeros(F)
    for _ in range(max_iter):
        if not mask.any():
            break
        c = solve(mask, alpha)
        new_mask = (np.abs(c) >= threshold) & mask
        coefs = np.where(new_mask, c, 0.0)
        if (new_mask == mask).all():
            mask = new_mask
            break
        mask = new_mask
    if unbias and mask.any():
        coefs = np.where(mask, solve(mask, 0.0), 0.0)
    return coefs, mask


def stlsq_hostsolve(theta, y, threshold, alpha, sample_weight=None,
                    max_iter: int = 100, initial_mask=None,
                    unbias: bool = True):
    """Global-discovery STLSQ: the N-row reduction happens on device (QR),
    the F×F thresholding iteration on the host (`stlsq_from_qr`).
    Returns numpy (coefs [F], mask [F])."""
    R, qty = _qr_reduce(jnp.asarray(theta), jnp.asarray(y),
                        None if sample_weight is None
                        else jnp.asarray(sample_weight))
    return stlsq_from_qr(R, qty, threshold, alpha, max_iter=max_iter,
                         initial_mask=initial_mask, unbias=unbias)


def masked_ridge(theta, y, alpha, mask=None, sample_weight=None):
    """One masked ridge solve (building block, exposed for tests)."""
    dtype = theta.dtype
    if sample_weight is not None:
        w = sample_weight.astype(dtype)
        gram = jnp.einsum('nf,ng,n->fg', theta, theta, w,
                          precision='highest')
        rhs = jnp.einsum('nf,n->f', theta, y * w, precision='highest')
    else:
        gram = jnp.einsum('nf,ng->fg', theta, theta, precision='highest')
        rhs = jnp.einsum('nf,n->f', theta, y, precision='highest')
    if mask is None:
        mask = jnp.ones(theta.shape[-1], bool)
    return _masked_solve(gram, rhs, mask, jnp.asarray(alpha, dtype))
