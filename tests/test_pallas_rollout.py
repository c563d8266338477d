"""Fused Pallas/Triton Euler+library rollout kernels, in interpret mode on
the CPU, and the choice between them and the XLA scan.  The compiled
kernels' parity on the GPU is checked by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest

from insite_tpu.discovery.library import PolynomialLibrary
from insite_tpu.models.sindy import batched_rollout
from insite_tpu.ops import pallas_batched_rollout


@pytest.mark.parametrize('B,T,shared', [(37, 15, True), (5, 9, False)])
def test_parity_with_xla_rollout(B, T, shared):
    lib = PolynomialLibrary(n_inputs=3)
    rng = np.random.RandomState(0)
    base = np.stack([[0, 0.3, 0, 0, -1.0, 0, 0],
                     [0, -0.2, 0, 0, 0, -1.0, 0]])
    if shared:
        coefs = jnp.asarray(base, jnp.float32)[None]
    else:
        coefs = jnp.asarray(
            base[None] * (1 + 0.1 * rng.randn(B, 1, 1)), jnp.float32)
    y0 = jnp.asarray(np.abs(rng.randn(B)) * 10 + 1, jnp.float32)
    statics = jnp.asarray(rng.rand(B, 2), jnp.float32)
    arms = jnp.asarray(rng.randint(0, 2, (B, T)), jnp.int32)

    ref = batched_rollout(lib, coefs, y0, statics, arms, 1 / 6,
                          joint=False, shared_coefs=shared)
    out = pallas_batched_rollout(lib, coefs, y0, statics, arms, 1 / 6,
                                 interpret=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-6)


def test_four_arm_selection():
    """Tumor-family layout: 4 treatment arms."""
    lib = PolynomialLibrary(n_inputs=2)
    rng = np.random.RandomState(1)
    B, T, A, F = 9, 7, 4, lib.n_features
    coefs = jnp.asarray(0.1 * rng.randn(1, A, F), jnp.float32)
    y0 = jnp.asarray(np.abs(rng.randn(B)) + 1, jnp.float32)
    statics = jnp.asarray(rng.rand(B, 1), jnp.float32)
    arms = jnp.asarray(rng.randint(0, A, (B, T)), jnp.int32)
    ref = batched_rollout(lib, coefs, y0, statics, arms, 1.0,
                          joint=False, shared_coefs=True)
    out = pallas_batched_rollout(lib, coefs, y0, statics, arms, 1.0,
                                 interpret=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-6)


def test_y_clip_bounds_divergence_and_matches_pallas():
    """y_clip projects the rollout onto the outcome's physical range: an
    unstable discovered model (positive feedback) stays bounded, and the
    Pallas kernel applies the identical projection."""
    import jax.numpy as jnp
    lib = PolynomialLibrary(n_inputs=2)
    F = len(lib.exponents())
    # dy/dt = +y  -> exponential divergence without clipping
    coefs = np.zeros((1, 2, F), np.float32)
    y_exp = [tuple(e) for e in lib.exponents()].index((1, 0))
    coefs[:, :, y_exp] = 1.0
    coefs = jnp.asarray(coefs)
    B, T = 8, 40
    y0 = jnp.full((B,), 5.0, jnp.float32)
    statics = jnp.ones((B, 1), jnp.float32)
    arms = jnp.zeros((B, T), jnp.int32)
    free = batched_rollout(lib, coefs, y0, statics, arms, 1.0,
                           shared_coefs=True)
    assert float(free.max()) > 1e6
    clip = (0.0, 10.0)
    ref = batched_rollout(lib, coefs, y0, statics, arms, 1.0,
                          shared_coefs=True, y_clip=clip)
    assert float(ref.max()) <= 10.0 and np.isfinite(np.asarray(ref)).all()
    out = pallas_batched_rollout(lib, coefs, y0, statics, arms, 1.0,
                                 y_clip=clip, interpret=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-6)


def test_sensitivity_kernel_matches_jacfwd():
    """pallas_rollout_with_sens integrates forward sensitivities that
    match jacfwd through the XLA rollout (the fine-tune's Jacobian)."""
    import jax
    from insite_tpu.ops.pallas_rollout import pallas_rollout_with_sens

    lib = PolynomialLibrary(n_inputs=3)
    rng = np.random.RandomState(0)
    B, T, A, F = 6, 12, 2, lib.n_features
    base = np.stack([[0, 0.3, 0, 0, -1.0, 0, 0],
                     [0, -0.2, 0, 0, 0, -1.0, 0]]).astype(np.float32)
    coefs = jnp.asarray(base[None] * (1 + 0.05 * rng.randn(B, 1, 1)),
                        jnp.float32)
    y0 = jnp.asarray(np.abs(rng.randn(B)) * 5 + 1, jnp.float32)
    statics = jnp.asarray(rng.rand(B, 2), jnp.float32)
    arms = jnp.asarray(rng.randint(0, 2, (B, T)), jnp.int32)
    active_idx = tuple(int(i) for i in
                       np.flatnonzero(np.abs(base.reshape(-1)) > 1e-3))

    y, s = pallas_rollout_with_sens(lib, coefs, y0, statics, arms, 1 / 6,
                                    active_idx, interpret=True)

    def roll_one(c_red, c_full, y0_i, st_i, arm_i):
        c = c_full.reshape(-1).at[jnp.asarray(active_idx)].set(c_red)
        return batched_rollout(lib, c.reshape(1, A, F), y0_i[None],
                               st_i[None], arm_i[None], 1 / 6,
                               joint=False, shared_coefs=True)[0]

    for b in range(B):
        c_red = coefs[b].reshape(-1)[jnp.asarray(active_idx)]
        ref_y = roll_one(c_red, coefs[b], y0[b], statics[b], arms[b])
        ref_J = jax.jacfwd(
            lambda cr: roll_one(cr, coefs[b], y0[b], statics[b],
                                arms[b]))(c_red)
        np.testing.assert_allclose(np.asarray(y[b]), np.asarray(ref_y),
                                   rtol=2e-5)
        np.testing.assert_allclose(np.asarray(s[b]), np.asarray(ref_J),
                                   rtol=2e-4, atol=1e-5)


def test_sensitivity_kernel_y_clip_zeroes_gradient():
    from insite_tpu.ops.pallas_rollout import pallas_rollout_with_sens
    lib = PolynomialLibrary(n_inputs=2)
    F = lib.n_features
    coefs = np.zeros((1, 2, F), np.float32)
    y_exp = [tuple(e) for e in lib.exponents()].index((1, 0))
    coefs[0, :, y_exp] = 1.0                    # dy/dt = +y (diverges)
    coefs = jnp.asarray(np.repeat(coefs, 3, 0))
    y0 = jnp.asarray([1.0, 2.0, 3.0], jnp.float32)
    statics = jnp.ones((3, 1), jnp.float32)
    arms = jnp.zeros((3, 10), jnp.int32)
    active_idx = (y_exp,)
    y, s = pallas_rollout_with_sens(lib, coefs, y0, statics, arms, 1.0,
                                    active_idx, y_clip=(0.0, 5.0),
                                    interpret=True)
    assert float(np.max(y)) <= 5.0
    # once clipped, the sensitivity is zeroed (clip jvp semantics)
    assert np.all(np.asarray(s)[:, -1] == 0.0)


@pytest.mark.slow
def test_pallas_gn_finetune_matches_xla_gn():
    """The batched Pallas LM fine-tune reproduces the XLA
    jvp-through-scan fine-tune (same objective, same update sequence)."""
    from insite_tpu.models.sindy import (insite_gn_finetune_predict,
                                         insite_gn_finetune_predict_pallas)

    lib = PolynomialLibrary(n_inputs=3)
    rng = np.random.RandomState(0)
    B, T = 8, 14
    base = np.stack([[0, 0.3, 0, 0, -1.0, 0, 0],
                     [0, -0.2, 0, 0, 0, -1.0, 0]]).astype(np.float32)
    # a retained SUB-threshold global coefficient (|c| <= 1e-3): skip rows
    # (seq_len <= projection_horizon) roll out the FULL unmasked global
    # model on both paths — this entry must survive into their rollout
    base[0, 0] = 8e-4
    g = jnp.asarray(base)
    active_idx = tuple(int(i) for i in
                       np.flatnonzero(np.abs(base.reshape(-1)) > 1e-3))
    prev = jnp.asarray(np.abs(rng.randn(B, T)) * 5 + 1, jnp.float32)
    statics = jnp.asarray(rng.rand(B, 2), jnp.float32)
    arms = jnp.asarray(rng.randint(0, 2, (B, 1)) *
                       np.ones((B, T), np.int32), jnp.int32)
    lengths = jnp.asarray([T, T, T, T, T, 3, T, 9], jnp.int32)

    p_x, c_x = insite_gn_finetune_predict(
        lib, g, prev, statics, arms, lengths, 1 / 6, 10.0,
        projection_horizon=5, gn_iters=6, active_idx=active_idx)
    p_p, c_p = insite_gn_finetune_predict_pallas(
        lib, g, prev, statics, arms, lengths, 1 / 6, 10.0,
        projection_horizon=5, gn_iters=6, active_idx=active_idx,
        interpret=True)
    np.testing.assert_allclose(np.asarray(c_p), np.asarray(c_x),
                               rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(p_p), np.asarray(p_x),
                               rtol=5e-4, atol=1e-4)


def _tiny_regressor(**cfg_kw):
    from insite_tpu.data import PkpdDatasetCollection
    from insite_tpu.models import sindy as sindy_mod
    coll = PkpdDatasetCollection(
        conf_coeff=2.0, num_patients={'train': 24, 'val': 4, 'test': 2},
        equation_str='EQ_4_D', seed=0)
    cfg = sindy_mod.SINDyConfig(dataset_name='EQ_4_D', sindy_threshold=0.1,
                                sindy_alpha=0.5, lam=10.0, insite=True,
                                **cfg_kw)
    return sindy_mod.SINDyRegressor(cfg, coll), coll


@pytest.mark.parametrize('backend,cfg_kw,mesh,expected', [
    ('gpu', {}, False, True),                         # auto on a GPU
    ('cpu', {}, False, False),                        # auto elsewhere
    ('gpu', {'rollout_backend': 'xla'}, False, False),
    ('cpu', {'rollout_backend': 'pallas'}, False, True),
    ('gpu', {}, True, False),                         # row-sharded: XLA
    ('gpu', {'joint_model': True}, False, False),     # joint library: XLA
    ('gpu', {'rollout_backend': 'pallas', 'joint_model': True}, False,
     False),
])
def test_kernel_choice(monkeypatch, backend, cfg_kw, mesh, expected):
    """`rollout_backend='auto'` takes the kernels exactly when the default
    backend is a GPU; a mesh or the joint model always takes the XLA scan;
    an explicit choice wins otherwise."""
    from insite_tpu.models import sindy as sindy_mod
    from insite_tpu.parallel import batch_mesh
    monkeypatch.setattr(sindy_mod.jax, 'default_backend', lambda: backend)
    m, _ = _tiny_regressor(**cfg_kw)
    if mesh:
        m.mesh = batch_mesh()
    assert m._use_pallas() is expected


def test_kernel_failure_is_not_swallowed(monkeypatch):
    """A kernel that fails fails the fine-tune: no fallback to the XLA
    scan hides it."""
    from insite_tpu.models import sindy as sindy_mod

    def boom(*a, **k):
        raise RuntimeError('kernel failed to lower')

    monkeypatch.setattr(sindy_mod, 'insite_gn_finetune_predict_pallas',
                        boom)
    m, coll = _tiny_regressor(rollout_backend='pallas')
    m.fit(coll.train_f)
    with pytest.raises(RuntimeError, match='failed to lower'):
        m._fine_tune(coll.train_f, 1)


def test_forced_kernel_off_the_gpu_needs_interpret_mode():
    """Compiled (not interpret) kernels exist only for the GPU: asking for
    them on the CPU raises instead of running something else."""
    lib = PolynomialLibrary(n_inputs=2)
    B, T = 4, 3
    coefs = jnp.zeros((1, 2, lib.n_features), jnp.float32)
    with pytest.raises(Exception, match='interpret'):
        pallas_batched_rollout(lib, coefs, jnp.ones(B, jnp.float32),
                               jnp.ones((B, 1), jnp.float32),
                               jnp.zeros((B, T), jnp.int32), 1.0)


@pytest.mark.parametrize('backend,expected', [('gpu', True),
                                              ('cpu', False)])
def test_kernels_default_follows_the_backend(monkeypatch, backend,
                                             expected):
    from insite_tpu import ops
    monkeypatch.setattr(ops.pallas_rollout.jax, 'default_backend',
                        lambda: backend)
    assert ops.kernels_default() is expected


@pytest.mark.parametrize('kernels', [True, False])
def test_northstar_takes_the_shared_kernel_default(monkeypatch, kernels):
    """fused_northstar's default fine-tune is `kernels_default()`'s choice:
    told the kernels are the default on the CPU, it runs the compiled
    kernel and fails (no interpret mode, no fallback)."""
    from insite_tpu.harness import northstar
    monkeypatch.setattr(northstar, 'kernels_default', lambda: kernels)
    if kernels:
        with pytest.raises(Exception, match='interpret'):
            northstar.fused_northstar(40, seed=0)
        return
    r = northstar.fused_northstar(40, seed=0)
    assert not r['used_pallas']
    assert r['preds'].shape == (40, 59)
    assert r['patient_coefs'].shape == (40,) + r['coefs'].shape


@pytest.fixture
def block_b(monkeypatch, request):
    """Set the kernels' patient block for one test; compiled kernels of
    other block sizes are dropped before and after."""
    import jax
    from insite_tpu.ops import pallas_rollout
    jax.clear_caches()
    monkeypatch.setattr(pallas_rollout, 'BLOCK_B', request.param)
    yield request.param
    jax.clear_caches()


@pytest.mark.parametrize('block_b', [32, 64], indirect=True)
def test_results_do_not_depend_on_the_block(block_b):
    """Padding the batch to whole blocks (here 70 rows -> 96 or 128) and
    the block size itself leave every real row's result unchanged: both
    kernels against the XLA rollout and jacfwd through it."""
    import jax
    from insite_tpu.ops.pallas_rollout import pallas_rollout_with_sens
    lib = PolynomialLibrary(n_inputs=3)
    rng = np.random.RandomState(3)
    B, T, A, F = 70, 6, 2, lib.n_features
    base = np.stack([[0, 0.3, 0, 0, -1.0, 0, 0],
                     [0, -0.2, 0, 0, 0, -1.0, 0]]).astype(np.float32)
    coefs = jnp.asarray(base[None] * (1 + 0.05 * rng.randn(B, 1, 1)),
                        jnp.float32)
    y0 = jnp.asarray(np.abs(rng.randn(B)) * 5 + 1, jnp.float32)
    statics = jnp.asarray(rng.rand(B, 2), jnp.float32)
    arms = jnp.asarray(rng.randint(0, 2, (B, T)), jnp.int32)
    act = (1, 4, 12)
    y, s = pallas_rollout_with_sens(lib, coefs, y0, statics, arms, 0.5, act,
                                    interpret=True)
    assert y.shape == (B, T) and s.shape == (B, T, len(act))
    out = pallas_batched_rollout(lib, coefs, y0, statics, arms, 0.5,
                                 interpret=True)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(y))

    ref = batched_rollout(lib, coefs, y0, statics, arms, 0.5)
    np.testing.assert_allclose(np.asarray(y), np.asarray(ref), rtol=1e-6)

    def roll_one(c_red, c_full, y0_i, st_i, arm_i):
        c = c_full.reshape(-1).at[jnp.asarray(act)].set(c_red)
        return batched_rollout(lib, c.reshape(1, A, F), y0_i[None],
                               st_i[None], arm_i[None], 0.5,
                               shared_coefs=True)[0]

    c_red = coefs.reshape(B, -1)[:, jnp.asarray(act)]
    ref_s = jax.vmap(jax.jacfwd(roll_one))(c_red, coefs, y0, statics, arms)
    np.testing.assert_allclose(np.asarray(s), np.asarray(ref_s), rtol=2e-4,
                               atol=1e-5)


def test_sensitivity_kernel_degree4_library():
    """The ablation's degree-4 library (powers of y up to 4, so dtheta/dy
    carries a power factor) through the sensitivity kernel, against
    jacfwd through the XLA rollout."""
    import jax
    from insite_tpu.ops.pallas_rollout import pallas_rollout_with_sens
    lib = PolynomialLibrary(n_inputs=2, degree=4, interaction_only=False)
    rng = np.random.RandomState(5)
    B, T, A, F = 4, 8, 2, lib.n_features
    c = np.zeros((A, F), np.float32)
    exps = [tuple(e) for e in lib.exponents()]
    c[:, exps.index((1, 0))] = [-0.5, -0.8]
    c[:, exps.index((2, 0))] = [0.02, -0.01]
    c[:, exps.index((4, 0))] = [-1e-4, 2e-4]
    c[:, exps.index((1, 1))] = [0.1, 0.0]
    coefs = jnp.asarray(np.repeat(c[None], B, 0))
    y0 = jnp.asarray(rng.uniform(1, 3, B), jnp.float32)
    statics = jnp.asarray(rng.rand(B, 1), jnp.float32)
    arms = jnp.asarray(rng.randint(0, A, (B, T)), jnp.int32)
    act = tuple(int(i) for i in np.flatnonzero(c.reshape(-1)))
    y, s = pallas_rollout_with_sens(lib, coefs, y0, statics, arms, 0.25,
                                    act, interpret=True)

    def roll(c_red, b):
        full = coefs[b].reshape(-1).at[jnp.asarray(act)].set(c_red)
        return batched_rollout(lib, full.reshape(1, A, F), y0[b][None],
                               statics[b][None], arms[b][None], 0.25,
                               shared_coefs=True)[0]

    for b in range(B):
        c_red = coefs[b].reshape(-1)[jnp.asarray(act)]
        np.testing.assert_allclose(np.asarray(y[b]),
                                   np.asarray(roll(c_red, b)), rtol=2e-5)
        np.testing.assert_allclose(
            np.asarray(s[b]),
            np.asarray(jax.jacfwd(lambda cr: roll(cr, b))(c_red)),
            rtol=2e-4, atol=1e-5)
