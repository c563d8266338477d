"""Fused Euler-step + candidate-library rollout as Pallas kernels for the
GPU, lowered through Triton (SURVEY.md §7 build-plan step 10: the inner
rollout of the discovered model).

The XLA version (`models.sindy.batched_rollout`) is a `lax.scan` of T steps
x STEPS_FOR_DT Euler sub-steps; on a GPU it becomes a device while-loop
that launches a few tiny fused kernels per step.  These kernels keep the
whole integration of a block of patients inside one program: state,
sensitivities and coefficients live in registers, one thread per patient,
and the time loop runs inside the kernel.

Layout: patients are the contiguous (last) axis of every operand —
coefficients ``[A*F, B]``, statics ``[S, B]``, arms and outputs ``[T, B]``,
sensitivities ``[Kr, T, B]`` — so each step's loads and stores coalesce.
The batch is padded to a whole number of BLOCK_B-patient blocks (no
masked loads, so interpret mode runs the same kernel on the CPU).

Two entry points:

- `pallas_batched_rollout`: forward prediction (global and fine-tuned
  rollouts, the exploded counterfactual test sets);
- `pallas_rollout_with_sens`: the INSITE Gauss-Newton fine-tune's
  rollout + Jacobian — the forward-sensitivity ODE
  ``s_j' = (dF/dy) s_j + theta_{f_j}(y) [arm == a_j]`` is integrated
  alongside the state, one kernel call per GN iteration.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from insite_tpu.core.constants import STEPS_FOR_DT

WARP = 32
# patients per program: one warp.  At 10k patients that is 313 programs
# for the H100's 132 SMs; 32 measured fastest on the card against 64, 128
# and 256 (PERF.md)
BLOCK_B = 32


def kernels_default() -> bool:
    """Whether the kernels are the default rollout path: on a GPU backend
    (the only target they compile for; elsewhere the XLA scan runs)."""
    return jax.default_backend() == 'gpu'


def _theta(planes, e):
    """Monomial prod_i planes[i]**e[i] (None for the constant feature)."""
    term = None
    for i, p in enumerate(e):
        for _ in range(int(p)):
            term = planes[i] if term is None else term * planes[i]
    return term


def _dtheta_dy(planes, e):
    """d/dy of the monomial (planes[0] is y); None when independent of y."""
    p0 = int(e[0])
    if p0 == 0:
        return None
    term = _theta([planes[0]] + list(planes[1:]), (p0 - 1,) + tuple(e[1:]))
    if term is None:
        return jnp.full_like(planes[0], float(p0))
    return term * p0 if p0 > 1 else term


def _arm_select(coefs, arm, A, F):
    """Per-patient coefficient c_k = coefs[arm * F + k] for every feature."""
    out = []
    for k in range(F):
        c_k = coefs[k]
        for a in range(1, A):
            c_k = jnp.where(arm == a, coefs[a * F + k], c_k)
        out.append(c_k)
    return out


def _rollout_kernel(coefs_ref, y0_ref, statics_ref, arms_ref, out_ref, *,
                    exps, A, F, S, T, dt, substeps, y_clip):
    """One program: integrate one block of patients for all T steps.

    coefs_ref [A*F, blk], y0_ref [blk], statics_ref [S, blk],
    arms_ref [T, blk] int32, out_ref [T, blk] predictions y[1..T]."""
    h = dt / substeps
    coefs = [coefs_ref[k, :] for k in range(A * F)]
    statics = [statics_ref[s, :] for s in range(S)]

    def step(t, carry):
        y, arm = carry
        # issue the next step's load now: its latency hides behind this
        # step's arithmetic instead of stalling the next one
        arm_next = arms_ref[jnp.minimum(t + 1, T - 1), :]
        c = _arm_select(coefs, arm, A, F)
        for _ in range(substeps):
            planes = [y] + statics
            dy = jnp.zeros_like(y)
            for k, e in enumerate(exps):
                th = _theta(planes, e)
                dy = dy + (c[k] if th is None else c[k] * th)
            y = y + h * dy
        if y_clip is not None:
            y = jnp.clip(y, y_clip[0], y_clip[1])
        out_ref[t, :] = y
        return y, arm_next

    lax.fori_loop(0, T, step, (y0_ref[:], arms_ref[0, :]))


def _sens_kernel(coefs_ref, y0_ref, statics_ref, arms_ref, out_ref,
                 sens_ref, *, exps, A, F, S, T, dt, substeps, y_clip,
                 active_idx):
    """Euler rollout + forward sensitivities for the active coefficient
    coordinates.

    For the library RHS F(y) = sum_k c_k theta_k(y, u) the sensitivity of
    the state wrt the flat coordinate j = (arm a_j, feature f_j) follows

        s_j <- s_j + h * ( dFdy * s_j + [arm == a_j] * theta_{f_j}(y) )

    evaluated at the pre-update state (exactly XLA's jvp through the same
    Euler arithmetic).  y_clip zeroes sensitivities where the state was
    clipped, matching jnp.clip's jvp.  sens_ref: [Kr, T, blk].
    """
    h = dt / substeps
    coefs = [coefs_ref[k, :] for k in range(A * F)]
    statics = [statics_ref[s, :] for s in range(S)]
    Kr = len(active_idx)

    def step(t, carry):
        y, sens, arm = carry
        arm_next = arms_ref[jnp.minimum(t + 1, T - 1), :]   # see above
        c = _arm_select(coefs, arm, A, F)
        for _ in range(substeps):
            planes = [y] + statics
            dy = jnp.zeros_like(y)
            dFdy = jnp.zeros_like(y)
            for k, e in enumerate(exps):
                th = _theta(planes, e)
                dy = dy + (c[k] if th is None else c[k] * th)
                d = _dtheta_dy(planes, e)
                if d is not None:
                    dFdy = dFdy + c[k] * d
            new_sens = []
            for j, (a_j, f_j) in enumerate(active_idx):
                drive = _theta(planes, exps[f_j])
                if drive is None:
                    drive = jnp.ones_like(y)
                if A > 1:
                    drive = jnp.where(arm == a_j, drive, jnp.zeros_like(y))
                new_sens.append(sens[j] + h * (dFdy * sens[j] + drive))
            sens = tuple(new_sens)
            y = y + h * dy
        if y_clip is not None:
            inside = (y > y_clip[0]) & (y < y_clip[1])
            y = jnp.clip(y, y_clip[0], y_clip[1])
            sens = tuple(jnp.where(inside, s, jnp.zeros_like(s))
                         for s in sens)
        out_ref[t, :] = y
        for j in range(Kr):
            sens_ref[j, t, :] = sens[j]
        return y, sens, arm_next

    y0 = y0_ref[:]
    lax.fori_loop(0, T, step,
                  (y0, tuple(jnp.zeros_like(y0) for _ in range(Kr)),
                   arms_ref[0, :]))


def _to_patient_minor(library, coefs, y0, statics, arms):
    """[B, ...] operands -> patient-minor layout padded to a whole number
    of blocks.  Returns (B_pad, coefs [A*F, B_pad], y0 [B_pad],
    statics [S, B_pad], arms [T, B_pad])."""
    B, T = arms.shape
    A, F = coefs.shape[-2:]
    assert len(library.exponents()) == F
    assert library.n_inputs == 1 + statics.shape[-1], \
        'joint mode is not supported by the kernel'
    B_pad = -(-B // BLOCK_B) * BLOCK_B
    pad = B_pad - B

    def minor(x):                          # [B, n] -> [n, B_pad]
        return jnp.pad(x.T, ((0, 0), (0, pad)))

    coefs_b = jnp.broadcast_to(coefs, (B, A, F)).reshape(B, A * F)
    return (B_pad, minor(coefs_b), jnp.pad(y0, (0, pad)), minor(statics),
            minor(arms.astype(jnp.int32)))


def _specs(A, F, S, T):
    return [
        pl.BlockSpec((A * F, BLOCK_B), lambda i: (0, i)),
        pl.BlockSpec((BLOCK_B,), lambda i: (i,)),
        pl.BlockSpec((S, BLOCK_B), lambda i: (0, i)),
        pl.BlockSpec((T, BLOCK_B), lambda i: (0, i)),
    ]


def _compiler_params():
    return pl_triton.CompilerParams(num_warps=max(1, BLOCK_B // WARP),
                                    num_stages=1)


@functools.partial(jax.jit, static_argnames=('library', 'dt', 'substeps',
                                             'interpret', 'y_clip',
                                             'active_idx'))
def pallas_rollout_with_sens(library, coefs, y0, statics, arms, dt,
                             active_idx, substeps=STEPS_FOR_DT,
                             interpret=False, y_clip=None):
    """Rollout + d y / d c_active in ONE kernel pass.

    coefs: [B, A, F] per-patient coefficients; active_idx: static tuple of
    flat (arm*F + feature) coordinates.  Returns (preds [B, T],
    sens [B, T, Kr]).  interpret=True runs the kernel on the CPU (tests).
    """
    B, T = arms.shape
    A, F = coefs.shape[-2:]
    S = statics.shape[-1]
    exps = tuple(map(tuple, library.exponents()))
    act = tuple((int(i) // F, int(i) % F) for i in active_idx)
    Kr = len(act)
    B_pad, coefs_p, y0_p, statics_p, arms_p = _to_patient_minor(
        library, coefs, y0, statics, arms)

    kernel = functools.partial(_sens_kernel, exps=exps, A=A, F=F, S=S, T=T,
                               dt=float(dt), substeps=substeps,
                               y_clip=y_clip, active_idx=act)
    out, sens = pl.pallas_call(
        kernel,
        grid=(B_pad // BLOCK_B,),
        in_specs=_specs(A, F, S, T),
        out_specs=[pl.BlockSpec((T, BLOCK_B), lambda i: (0, i)),
                   pl.BlockSpec((Kr, T, BLOCK_B), lambda i: (0, 0, i))],
        out_shape=[jax.ShapeDtypeStruct((T, B_pad), y0.dtype),
                   jax.ShapeDtypeStruct((Kr, T, B_pad), y0.dtype)],
        backend='triton',
        compiler_params=_compiler_params(),
        interpret=interpret,
        name='insite_rollout_sens',
    )(coefs_p, y0_p, statics_p, arms_p)
    return out[:, :B].T, jnp.moveaxis(sens[:, :, :B], (0, 2), (2, 0))


@functools.partial(jax.jit, static_argnames=('library', 'dt', 'substeps',
                                             'interpret', 'y_clip'))
def pallas_batched_rollout(library, coefs, y0, statics, arms, dt,
                           substeps=STEPS_FOR_DT, interpret=False,
                           y_clip=None):
    """`batched_rollout(..., joint=False)` on the GPU.

    coefs: [1, A, F] (shared by every row) or [B, A, F]; y0: [B];
    statics: [B, S]; arms: [B, T] integer arm per step.  Returns [B, T]
    predictions.  interpret=True runs the kernel on the CPU (tests).
    """
    B, T = arms.shape
    A, F = coefs.shape[-2:]
    S = statics.shape[-1]
    exps = tuple(map(tuple, library.exponents()))
    B_pad, coefs_p, y0_p, statics_p, arms_p = _to_patient_minor(
        library, coefs, y0, statics, arms)

    kernel = functools.partial(_rollout_kernel, exps=exps, A=A, F=F, S=S,
                               T=T, dt=float(dt), substeps=substeps,
                               y_clip=y_clip)
    out = pl.pallas_call(
        kernel,
        grid=(B_pad // BLOCK_B,),
        in_specs=_specs(A, F, S, T),
        out_specs=pl.BlockSpec((T, BLOCK_B), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((T, B_pad), y0.dtype),
        backend='triton',
        compiler_params=_compiler_params(),
        interpret=interpret,
        name='insite_rollout',
    )(coefs_p, y0_p, statics_p, arms_p)
    return out[:, :B].T
