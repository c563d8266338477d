"""Weak-form SINDy (A-WSINDy): integrate the candidate library against
compactly-supported test functions so no derivative estimate is needed.

Reference uses pysindy's WeakPDELibrary (K=100 random subdomains, polynomial
test functions) + SR3(l1, normalize_columns) (sindy.py:218-271; EQ_4 only —
run.py:100-102 skips wsindy elsewhere).  Batched version: the K window
integrals for *every trajectory at once* are two einsum contractions against
precomputed quadrature weights; SR3 is a fixed-iteration prox loop.

Window defaults (window_len=30 of the 59-step grid, test function
(1-s^2)^2) were selected on *factual validation* RMSE over a
(window_len, p) grid on EQ_4 — wider/gentler windows than pysindy's
defaults halve the counterfactual RMSE vs the reference (0.06 vs 0.102 on
EQ_4_D) because the weak integrals average observation noise over more of
the trajectory while the dynamics stay well within the window.

Weak form on window [a, b] with phi(a)=phi(b)=0:
    integral(phi * x') = -integral(phi' * x)
so each (trajectory, window) pair contributes one linear equation
    -<phi', x> = sum_j c_j <phi, theta_j(x)>.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def _test_functions(n_windows: int, window_len: int, t_len: int, seed=0,
                    p: int = 2, all_starts: bool = False):
    """phi and phi' sampled on the grid for K windows placed (deterministic
    rng) over [0, t_len).  Returns (starts [K], phi [K, w], dphi [K, w]) in
    grid units; scale dphi by 1/dt outside.

    ``all_starts=True`` places one window at EVERY grid start (K =
    t_len - window_len + 1, ignoring n_windows/seed) — required when
    window validity is decided per (trajectory, window) by a constant-
    treatment-segment mask (tumor family: segments are 1-11 steps, so
    random placement would miss nearly all of them).

    ``p`` is the test-function exponent, phi = (1 - s^2)^p.  For tiny
    windows p must be 1: with window_len=3, (1-s^2)^2 has phi' = 0 at all
    three grid points s in {-1, 0, 1} and the weak equation degenerates
    to 0 = <phi, theta>; p=1 gives phi' = -2s, recovering a centered-
    difference-like relation."""
    if all_starts:
        starts = np.arange(max(t_len - window_len + 1, 1))
        n_windows = len(starts)
    else:
        rng = np.random.RandomState(seed)
        starts = rng.randint(0, max(t_len - window_len, 1), size=n_windows)
    s = np.linspace(-1.0, 1.0, window_len)
    phi = (1 - s ** 2) ** p
    dphi_ds = -2 * p * s * (1 - s ** 2) ** (p - 1)
    # d/dt = d/ds * ds/dt, ds/dt = 2/(window_len-1 grid steps)
    scale = 2.0 / (window_len - 1)
    phi_k = np.broadcast_to(phi, (n_windows, window_len))
    dphi_k = np.broadcast_to(dphi_ds * scale, (n_windows, window_len))
    return starts, phi_k, dphi_k


def _hat_weights(window_len: int, p: int):
    """Exact quadrature weights for the weak integrals against the
    piecewise-LINEAR interpolant of the grid samples.

    Sampling phi/phi' at the grid and applying trapezoid quadrature is
    systematically biased on coarse windows: at window_len=3, p=1 the
    trapezoid value of <phi, theta> is 3/4 of the true integral while
    |<phi', x>| is overestimated 3/2x, inflating every recovered
    coefficient by 2x (measured on noise-free exponential decays).
    Instead precompute W[i] = integral(phi(s) * hat_i(s) ds) and
    Wd[i] = integral(phi'(s) * hat_i(s) ds) on a fine grid (f64, host,
    once per window length) so that sum_i g_i * W[i] is EXACT for any
    piecewise-linear g.  Remaining error is the interpolant's own
    O(dt^2), unbiased in the window size.

    Returns (W [w], Wd [w]) in s units over [-1, 1]:
      integral(phi * g dt)  = (window_len-1)*dt/2 * sum_i g_i W[i]
      integral(phi'_t * g dt) = sum_i g_i Wd[i]      (chain rule: the
      ds/dt and dt/ds factors cancel exactly)
    """
    M = 4001
    s = np.linspace(-1.0, 1.0, M)
    phi = (1 - s ** 2) ** p
    dphi = -2 * p * s * (1 - s ** 2) ** (p - 1)
    h = 2.0 / (window_len - 1)
    nodes = np.linspace(-1.0, 1.0, window_len)
    W = np.zeros(window_len)
    Wd = np.zeros(window_len)
    for i, si in enumerate(nodes):
        hat = np.clip(1.0 - np.abs(s - si) / h, 0.0, None)
        W[i] = np.trapezoid(phi * hat, s)
        Wd[i] = np.trapezoid(dphi * hat, s)
    return W, Wd


def weak_system(volumes, statics, lengths, library, dt,
                n_windows: int = 100, window_len: int = 30,
                trajectory_mask=None, seed: int = 0,
                step_arms=None, arm=None, all_starts: bool = False,
                p: int = 2):
    """Build the flattened weak-form linear system (A, b, sample_weight).

    volumes: [B, T] padded; statics: [B, S]; lengths: [B] valid VOLUME
    points (a window [s, s+w) is kept iff s + w <= lengths).
    trajectory_mask: [B] bool — which trajectories feed this arm's system
    (EQ_4: the whole trajectory runs one constant arm).
    step_arms/arm: [B, T-1] per-transition arm index + target arm — a
    window is kept iff ALL transitions it spans (s .. s+w-2) ran `arm`
    (tumor family: trajectories are concatenations of short constant-
    treatment segments, pkpd/utils.py:433-462; the weak form of arm a's
    ODE only holds on intervals where arm a was applied throughout).
    all_starts/p: see _test_functions.
    """
    B, T = volumes.shape
    window_len = min(window_len, T)
    starts_np, _, _ = _test_functions(n_windows, window_len, T,
                                      seed=seed, p=p,
                                      all_starts=all_starts)
    n_windows = len(starts_np)
    starts = jnp.asarray(starts_np)
    # exact piecewise-linear quadrature weights (see _hat_weights): the
    # phi weight carries the dt-measure factor, the phi' weight needs
    # none (chain rule cancellation)
    W_np, Wd_np = _hat_weights(window_len, p)
    wphi = jnp.asarray(W_np * ((window_len - 1) * dt / 2.0), volumes.dtype)
    wdphi = jnp.asarray(Wd_np, volumes.dtype)

    # windows fully inside the valid region only
    ok_win = (starts[None, :] + window_len) <= \
        jnp.asarray(lengths)[:, None]                    # [B, K]
    if trajectory_mask is not None:
        ok_win = ok_win & jnp.asarray(trajectory_mask)[:, None]
    if step_arms is not None:
        # transitions spanned by volume window [s, s+w): s .. s+w-2
        tr_idx = jnp.clip(
            starts[:, None] + jnp.arange(window_len - 1)[None, :],
            0, step_arms.shape[1] - 1)                   # [K, w-1]
        ok_win = ok_win & jnp.all(step_arms[:, tr_idx] == arm, axis=-1)

    idx = starts[:, None] + jnp.arange(window_len)[None, :]   # [K, w]
    x_win = volumes[:, idx]                                   # [B, K, w]
    X = jnp.concatenate(
        [x_win[..., None],
         jnp.broadcast_to(statics[:, None, None, :],
                          (B, n_windows, window_len, statics.shape[-1]))],
        axis=-1)
    theta = library(X)                                        # [B, K, w, F]

    # f32 contractions default to TF32 on the GPU: keep them exact
    lhs = -jnp.einsum('bkw,w->bk', x_win, wdphi, precision='highest')
    rhs = jnp.einsum('bkwf,w->bkf', theta, wphi, precision='highest')

    w = ok_win.reshape(-1).astype(volumes.dtype)
    A = rhs.reshape(-1, rhs.shape[-1])
    b = lhs.reshape(-1)
    return A, b, w


def weak_system_segments(volumes, statics, n_volume_points, library, dt,
                         step_arms, arm, window_lens=(8, 5, 3)):
    """Multi-scale weak system for one arm of a SEGMENTED trajectory
    (tumor family, cancer_simulation.py treatment assignment): constant-
    treatment segments are 1-11 steps long (median 1-2), so one window
    scale cannot both fit the short treated segments and average noise
    over the longer untreated ones.  Build one all-starts weak system per
    scale — each window kept only when every transition it spans ran
    `arm` — and stack the scales into one flattened (A, b, w) system.
    Tiny scales (w <= 4) use the p=1 test function (see _test_functions).

    n_volume_points: [B] count of valid volume samples per trajectory
    (= sequence_lengths + 1 for the tumor wrappers: lengths transitions
    pair lengths+1 volume points, models/sindy.py::_fit_tumor).
    """
    parts = []
    for w in window_lens:
        parts.append(weak_system(
            volumes, statics, n_volume_points, library, dt,
            window_len=int(w), all_starts=True, step_arms=step_arms,
            arm=arm, p=(1 if w <= 4 else 2)))
    A = jnp.concatenate([a for a, _, _ in parts], axis=0)
    b = jnp.concatenate([b_ for _, b_, _ in parts], axis=0)
    wt = jnp.concatenate([w_ for _, _, w_ in parts], axis=0)
    return A, b, wt


def weak_sindy_fit(volumes, statics, lengths, library, dt,
                   threshold: float, n_windows: int = 100,
                   window_len: int = 30, sr3_iters: int = 1000,
                   trajectory_mask=None, seed: int = 0,
                   solver: str = 'stlsq'):
    """Fit coefficients [F] by weak-form regression at one threshold."""
    A, b, w = weak_system(volumes, statics, lengths, library, dt,
                          n_windows=n_windows, window_len=window_len,
                          trajectory_mask=trajectory_mask, seed=seed)
    if solver == 'sr3':
        return sr3_l1(A, b, w, threshold, max_iter=sr3_iters)
    return weak_stlsq(A, b, w, threshold)


def weak_sindy_fit_select(volumes, statics, lengths, library, dt,
                          thresholds, flat_theta, flat_y, sample_w,
                          alphas=None, select_tol: float = 0.05,
                          n_windows: int = 100, window_len: int = 30,
                          trajectory_mask=None, seed: int = 0):
    """Threshold-grid weak-form fit with strong-form model selection.

    The hard threshold of `weak_stlsq` acts in correlation units on
    near-collinear weak columns, and at an unlucky cohort draw a single
    fixed threshold can land on a degenerate support (EQ_4_D seed 6: the
    dominant x0*u0 term is dropped, mass moves to u0 and u0*u1, and the
    counterfactual RMSE blows up 100x while 9/10 seeds beat the
    reference).  The reference's pysindy SR3(l1) path is equally
    threshold-sensitive — it simply never hits the bad basin on its 10
    shipped seeds.  Robust, protocol-clean fix: fit the SAME weak system
    at a small grid of thresholds (one vmapped solve) and keep the
    candidate whose STRONG-form residual on the training samples
    (flat_theta @ c vs the finite-difference derivative flat_y, the data
    SINDy itself trains on — no validation or test information) is
    within `select_tol` of the best, preferring the sparsest such model
    (larger threshold breaks nnz ties).  Fully traceable: used verbatim
    by the vectorized seed columns.

    thresholds: [G] ascending; flat_theta [N, F], flat_y [N],
    sample_w [N] — this arm's strong-form design from `_eq4_design`.
    Returns coefficients [F].
    """
    A, b, w = weak_system(volumes, statics, lengths, library, dt,
                          n_windows=n_windows, window_len=window_len,
                          trajectory_mask=trajectory_mask, seed=seed)
    thresholds = jnp.asarray(thresholds, A.dtype)
    if alphas is None:
        alphas = jnp.full_like(thresholds, 0.5)
    else:
        alphas = jnp.asarray(alphas, A.dtype)
    cands = jax.vmap(lambda th, al: weak_stlsq(A, b, w, th, alpha=al))(
        thresholds, alphas)
    return cands[weak_select_traced(cands, flat_theta, flat_y, sample_w,
                                    select_tol=select_tol)]


def weak_select_traced(cands, flat_theta, flat_y, sample_w,
                       select_tol: float = 0.05):
    """Traced candidate-selection rule: index of the sparsest candidate
    whose strong-form training residual is within `select_tol` of the
    best; equal nnz -> later grid index (larger threshold); an all-zero
    candidate (nnz=0 fits nothing) only if no nonzero one is admissible.
    Mirrors `weak_select_host` (unit-tested against it)."""
    resid = jnp.matmul(flat_theta, cands.T,
                       precision='highest') - flat_y[:, None]  # [N, G]
    wn = jnp.maximum(jnp.sum(sample_w), 1.0)
    rmse = jnp.sqrt(jnp.sum(resid * resid * sample_w[:, None], axis=0) / wn)
    nnz = jnp.sum(jnp.abs(cands) > 1e-12, axis=-1)            # [G]
    admissible = rmse <= jnp.min(rmse) * (1.0 + select_tol)
    G, F = cands.shape
    # the zero-support sentinel must stay small: F+1 sorts after every
    # real support (nnz <= F) without overflowing the int32 key the way
    # a huge constant would (iinfo.max//2 * G wraps NEGATIVE for G >= 2,
    # which made an admissible null model win argmin — the exact
    # collapse this selection exists to prevent)
    nnz_eff = jnp.where(nnz > 0, nnz, F + 1)
    key = jnp.where(admissible, nnz_eff * G + (G - 1 - jnp.arange(G)),
                    (F + 2) * G + G)
    return jnp.argmin(key)


def weak_stlsq_host(A, b, sample_weight, threshold, alpha: float = 0.5,
                    max_iter: int = 20):
    """`weak_stlsq` semantics in HOST float64 (numpy).

    The weak system's whitened normal equations are too ill-conditioned
    for an f32 solve: at unlucky cohort draws the f32 Gram loses the
    dominant term's correlation entirely and the support collapses at
    EVERY threshold (EQ_4_D seed 6 — the f64 solve recovers the true
    model at the same thresholds).  The strong-form path already solves
    on host f64 (`stlsq_hostsolve`); this is the weak-form analog.
    Inputs are numpy arrays (device_get'd once by the caller)."""
    A64 = np.asarray(A, np.float64) * np.asarray(sample_weight,
                                                 np.float64)[:, None]
    b64 = np.asarray(b, np.float64) * np.asarray(sample_weight, np.float64)
    norms = np.sqrt((A64 * A64).sum(0))
    norms[norms == 0] = 1.0
    An = A64 / norms
    bn = b64 / max(np.linalg.norm(b64), 1e-300)
    G = An.T @ An
    rhs = An.T @ bn
    F = A64.shape[1]
    eye = np.eye(F)
    mask = np.ones(F, bool)
    for _ in range(max_iter):
        m = mask.astype(np.float64)
        Gm = G * np.outer(m, m) + np.diag(1.0 - m) + alpha * eye
        c = np.linalg.solve(Gm, rhs * m)
        mask = np.abs(c) > threshold
    m = mask.astype(np.float64)
    Gw = A64.T @ A64
    Gr = Gw * np.outer(m, m) + np.diag(1.0 - m) + \
        1e-12 * np.trace(Gw) / F * eye
    c_raw = np.linalg.solve(Gr, (A64.T @ b64) * m)
    return np.where(mask, c_raw, 0.0)


def weak_select_host(cands, grid, flat_theta, flat_y, sample_w,
                     select_tol: float = 0.05):
    """Host-side candidate selection: sparsest model whose strong-form
    training residual is within `select_tol` of the best (equal nnz ->
    later grid index, i.e. larger threshold — and among one threshold's
    alpha block, the later/smaller alpha, matching `weak_select_traced`
    exactly).  `grid` is kept for the caller's logging only."""
    del grid   # ordering is by index, same as the traced rule
    cands = np.asarray(cands, np.float64)              # [G, F]
    th = np.asarray(flat_theta, np.float64)
    y = np.asarray(flat_y, np.float64)
    w = np.asarray(sample_w, np.float64)
    resid = th @ cands.T - y[:, None]
    rmse = np.sqrt((resid * resid * w[:, None]).sum(0) / max(w.sum(), 1.0))
    nnz = (np.abs(cands) > 1e-12).sum(-1)
    admissible = rmse <= rmse.min() * (1.0 + select_tol)
    G = len(cands)
    order = np.lexsort((-np.arange(G), np.where(nnz > 0, nnz, 10**9)))
    g = next(int(i) for i in order if admissible[i])
    return cands[g], g


@partial(jax.jit, static_argnames=('max_iter',))
def weak_stlsq(A, b, sample_weight, threshold, alpha: float = 0.5,
               max_iter: int = 20):
    """Sequential hard thresholding in *correlation units* on the weak
    system, then an unbiased raw-space refit on the support.

    The weak system's time-constant columns (bias / static monomials) are
    near-parallel — every window integrates them to the same shape — so a
    plain least-squares puts giant canceling coefficients on that near-null
    space (catastrophically in f32).  Whitening both sides (unit-norm
    columns AND unit-norm b) makes the ridge alpha and the hard threshold
    scale-free: a column whose marginal correlation with b is below
    `threshold` is dropped regardless of raw magnitudes, which is the
    sparse fixed point pysindy's SR3(l1, normalize_columns, tol=1e-1)
    lands on in practice."""
    Aw = A * sample_weight[:, None]
    bw = b * sample_weight
    norms = jnp.sqrt(jnp.sum(Aw * Aw, axis=0))
    norms = jnp.where(norms > 0, norms, 1.0)
    An = Aw / norms[None, :]
    bn = bw / jnp.maximum(jnp.linalg.norm(bw), 1e-30)
    # true-f32 accumulation (f32 matmuls default to TF32 on the GPU)
    G = jnp.einsum('nf,ng->fg', An, An, precision='highest')
    rhs = jnp.einsum('nf,n->f', An, bn, precision='highest')
    F = A.shape[1]
    eye = jnp.eye(F, dtype=A.dtype)

    def body(mask, _):
        m = mask.astype(A.dtype)
        Gm = G * jnp.outer(m, m) + jnp.diag(1.0 - m) + alpha * eye
        c = jnp.linalg.solve(Gm, rhs * m)
        return jnp.abs(c) > threshold, None

    mask, _ = lax.scan(body, jnp.ones(F, bool), None, length=max_iter)
    # unbiased refit on the support in raw units (small alpha for f32)
    m = mask.astype(A.dtype)
    Gw = jnp.einsum('nf,ng->fg', Aw, Aw, precision='highest')
    Gr = Gw * jnp.outer(m, m) + jnp.diag(1.0 - m) + \
        1e-8 * jnp.trace(Gw) / F * eye
    c_raw = jnp.linalg.solve(
        Gr, jnp.einsum('nf,n->f', Aw, bw, precision='highest') * m)
    return jnp.where(mask, c_raw, 0.0)


@partial(jax.jit, static_argnames=('max_iter',))
def sr3_l1(A, b, sample_weight, threshold, nu: float = 1.0,
           max_iter: int = 1000):
    """SR3 with l1 relax-and-split (pysindy SR3(thresholder='l1',
    normalize_columns=True) semantics): minimise
    0.5||b - Aw||^2 + threshold*|u|_1 + (0.5/nu)||w - u||^2."""
    wgt = sample_weight
    Aw = A * wgt[:, None]
    # column normalisation (pysindy normalize_columns=True)
    norms = jnp.sqrt(jnp.sum(Aw * Aw, axis=0))
    norms = jnp.where(norms > 0, norms, 1.0)
    An = Aw / norms[None, :]
    bw = b * wgt
    G = jnp.einsum('nf,ng->fg', An, An, precision='highest')
    rhs0 = jnp.einsum('nf,n->f', An, bw, precision='highest')
    F = A.shape[1]
    H = G + (1.0 / nu) * jnp.eye(F, dtype=A.dtype)
    cho = jax.scipy.linalg.cho_factor(H)

    def body(u, _):
        w = jax.scipy.linalg.cho_solve(cho, rhs0 + u / nu)
        u_new = jnp.sign(w) * jnp.maximum(jnp.abs(w) - threshold * nu, 0.0)
        return u_new, None

    u0 = jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(G + 1e-10 * jnp.eye(F, dtype=A.dtype)),
        rhs0)
    u, _ = lax.scan(body, u0, None, length=max_iter)
    # unbias on the support, then undo column scaling
    support = jnp.abs(u) > 1e-12
    m = support.astype(A.dtype)
    Gm = G * jnp.outer(m, m) + jnp.diag(1.0 - m) + 1e-12 * jnp.eye(F)
    coef = jnp.linalg.solve(Gm, rhs0 * m)
    return jnp.where(support, coef, 0.0) / norms
