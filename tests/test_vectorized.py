"""Vectorized multi-seed benchmark (harness/vectorized.py): every seed's
simulate->discover->fine-tune->evaluate pipeline vmapped into one program."""

import numpy as np
import pytest

from insite_tpu.harness.vectorized import vectorized_eq4_sweep


def test_insite_sweep_two_seeds():
    r = vectorized_eq4_sweep('EQ_4_D', n_seeds=2, n_train=100, n_test=10,
                             method='insite')
    v = r['encoder_test_rmse_orig']
    assert v.shape == (2,)
    assert np.isfinite(v).all()
    assert (v < 0.1).all()          # INSITE-level accuracy
    assert r['global_coefs'].shape == (2, 2, 7)
    # seeds genuinely differ (different cohorts)
    assert v[0] != v[1]


def test_sindy_sweep_matches_standard_harness():
    """The vectorized path must agree with run_experiment's protocol at
    the same workload (device QR STLSQ vs host solve -> tolerance, not
    bitwise)."""
    from insite_tpu.harness.config import RunConfig
    from insite_tpu.harness.runner import run_experiment
    r_vec = vectorized_eq4_sweep('EQ_4_D', n_seeds=1, n_train=100,
                                 n_test=10, method='sindy')
    cfg = RunConfig(train_samples=100, val_samples=10, test_samples=10)
    r_std = run_experiment('EQ_4_D', 'sindy', seed=0, domain_conf=2.0,
                           cfg=cfg)
    np.testing.assert_allclose(r_vec['encoder_test_rmse_orig'][0],
                               r_std['encoder_test_rmse_orig'], rtol=0.2)


def test_sweep_sharded_over_mesh_matches_single_device():
    """Seed axis sharded over the 8-device mesh: same results, no
    collectives (embarrassingly parallel scaling)."""
    from insite_tpu.parallel import batch_mesh
    r1 = vectorized_eq4_sweep('EQ_4_D', n_seeds=8, n_train=50, n_test=8,
                              method='sindy')
    r8 = vectorized_eq4_sweep('EQ_4_D', n_seeds=8, n_train=50, n_test=8,
                              method='sindy', mesh=batch_mesh())
    np.testing.assert_allclose(r8['encoder_test_rmse_orig'],
                               r1['encoder_test_rmse_orig'], rtol=1e-5)


def test_n_step_metrics_present():
    r = vectorized_eq4_sweep('EQ_4_D', n_seeds=1, n_train=60, n_test=8,
                             method='insite')
    for k in range(2, 7):
        v = r[f'decoder_test_rmse_{k}-step']
        assert v.shape == (1,) and np.isfinite(v).all()
    # n-step error grows with horizon on average
    assert r['decoder_test_rmse_6-step'][0] >= \
        r['decoder_test_rmse_2-step'][0] * 0.5


def test_confounding_sweep_grid():
    from insite_tpu.harness.vectorized import vectorized_confounding_sweep
    r = vectorized_confounding_sweep('EQ_4_D', gammas=(0.0, 4.0), n_seeds=2,
                                     n_train=60, n_test=8, method='sindy')
    assert r['encoder_test_rmse_orig'].shape == (2, 2)
    assert np.isfinite(r['encoder_test_rmse_orig']).all()
    assert r['decoder_test_rmse_6-step'].shape == (2, 2)


def test_tumor_sweep_smoke():
    from insite_tpu.harness.vectorized import vectorized_tumor_sweep
    r = vectorized_tumor_sweep('cancer_sim', n_seeds=2, n_train=40,
                               n_test=6, seq_length=20, method='insite')
    v = r['encoder_test_rmse_orig']
    assert v.shape == (2,) and np.isfinite(v).all()
    assert r['global_coefs'].shape == (2, 4, 4)   # 4 arms, 4 features
    for k in range(2, 7):
        assert np.isfinite(r[f'decoder_test_rmse_{k}-step']).all()


def test_tumor_sweep_eq5_variants_differ():
    from insite_tpu.harness.vectorized import vectorized_tumor_sweep
    ra = vectorized_tumor_sweep('EQ_5_A', n_seeds=1, n_train=40, n_test=6,
                                seq_length=20, method='sindy')
    rd = vectorized_tumor_sweep('EQ_5_D', n_seeds=1, n_train=40, n_test=6,
                                seq_length=20, method='sindy')
    assert not np.allclose(ra['encoder_test_rmse_orig'],
                           rd['encoder_test_rmse_orig'])


def test_cohorts_bitwise_match_standard_collection():
    """The vectorized path's key discipline replicates
    PkpdDatasetCollection.subset, so simulated cohorts are bit-identical."""
    import jax
    import jax.numpy as jnp
    from insite_tpu.core.dtypes import default_float
    from insite_tpu.data import PkpdDatasetCollection
    from insite_tpu.sim import pkpd

    seed, n, T = 0, 16, 60
    coll = PkpdDatasetCollection(
        conf_coeff=2.0, num_patients={'train': n, 'val': 2, 'test': 2},
        equation_str='EQ_4_D', seed=seed)

    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    params = dict(pkpd.get_standard_params(n, pkpd.Equation.EQ_4_D, sub))
    from insite_tpu.core.constants import MAX_VALUE
    params['observation_noise'] = pkpd.OBSERVATION_NOISE
    params['sigmoid_intercept'] = MAX_VALUE / 2.0
    params['sigmoid_gamma'] = 2.0 / MAX_VALUE
    key, sub = jax.random.split(key)
    vol, treat, lengths = pkpd._simulate_factual_full(
        params, sub, T, True, dtype=default_float())

    np.testing.assert_array_equal(np.asarray(vol),
                                  coll.train_f.data['cancer_volume'])
    np.testing.assert_array_equal(np.asarray(lengths),
                                  coll.train_f.data['sequence_lengths'])


def test_tumor_sweep_eq5_includes_dosage_covariate():
    """EQ_5 variants use the 3-input library (volume, patient_type, t=0
    chemo dosage) matching the standard harness's
    include_continuous_treatment layout; cancer_sim stays 2-input."""
    from insite_tpu.harness.vectorized import vectorized_tumor_sweep
    r = vectorized_tumor_sweep('EQ_5_A', n_seeds=1, n_train=40, n_test=6,
                               seq_length=20, method='sindy')
    # degree-2 interaction-only over 3 inputs: 1 + 3 + 3 = 7 features
    assert r['global_coefs'].shape == (1, 4, 7)
    # the dosage input is identically zero at t=0, so every feature
    # involving it must have coefficient exactly 0
    from insite_tpu.discovery.library import PolynomialLibrary
    lib = PolynomialLibrary(n_inputs=3)
    names = lib.feature_names(['x0', 'u0', 'u1'])
    dose_cols = [i for i, nm in enumerate(names) if 'u1' in nm]
    assert dose_cols, 'dosage features missing from the library'
    assert np.all(r['global_coefs'][..., dose_cols] == 0.0)


@pytest.mark.slow
def test_vectorized_ct_sweep_mesh_matches_unsharded():
    """Seed-sharding the CT column over a 2-device mesh reproduces the
    single-device column: training programs are seed-independent, so the
    mesh only changes placement, not math."""
    import jax
    import numpy as np
    from insite_tpu.harness.vectorized_neural import vectorized_ct_sweep
    from insite_tpu.parallel import batch_mesh
    kw = dict(num_patients={'train': 40, 'val': 8, 'test': 6},
              epochs=2, eval_chunk=16)
    base = vectorized_ct_sweep('EQ_4_D', n_seeds=2, **kw)
    mesh = batch_mesh(jax.devices()[:2])
    sharded = vectorized_ct_sweep('EQ_4_D', n_seeds=2, mesh=mesh, **kw)
    assert set(base) == set(sharded)
    for k in base:
        np.testing.assert_allclose(sharded[k], base[k], rtol=1e-4, atol=1e-6)


@pytest.mark.slow
def test_vectorized_gnet_sweep_mesh_matches_unsharded():
    """Seed-sharding the G-Net column (training + MC rollouts with the
    sharded residual bank) over a 2-device mesh reproduces the
    single-device column (VERDICT r2 #8: promote the dryrun's sharded
    G-Net column assertion into the test suite)."""
    import jax
    import numpy as np
    from insite_tpu.harness.vectorized_neural import vectorized_gnet_sweep
    from insite_tpu.parallel import batch_mesh
    kw = dict(num_patients={'train': 40, 'val': 8, 'test': 6},
              epochs=2, eval_chunk=16, mc_samples=2)
    base = vectorized_gnet_sweep('EQ_4_D', n_seeds=2, **kw)
    mesh = batch_mesh(jax.devices()[:2])
    sharded = vectorized_gnet_sweep('EQ_4_D', n_seeds=2, mesh=mesh, **kw)
    assert set(base) == set(sharded)
    for k in base:
        np.testing.assert_allclose(sharded[k], base[k], rtol=1e-4, atol=1e-6)


@pytest.mark.slow
def test_vectorized_enc_dec_seed_block_matches_whole_column():
    """A seed-blocked EDCT column concatenates to the whole column.

    Guards the single-chip OOM workaround (seed_block=5 default for EDCT):
    seeds never couple across the stacked axis, so running the column in
    blocks must land the same per-seed metrics bit-for-bit (f64 CPU)."""
    import numpy as np
    from insite_tpu.harness.vectorized_neural import vectorized_enc_dec_sweep
    kw = dict(num_patients={'train': 40, 'val': 8, 'test': 6},
              epochs=2, eval_chunk=64)
    whole = vectorized_enc_dec_sweep('edct', 'EQ_4_D', n_seeds=2,
                                     seed_block=0, **kw)
    blocked = vectorized_enc_dec_sweep('edct', 'EQ_4_D', n_seeds=2,
                                       seed_block=1, **kw)
    assert set(whole) == set(blocked)
    for k in whole:
        np.testing.assert_allclose(blocked[k], whole[k],
                                   rtol=1e-6, atol=1e-9, err_msg=k)


@pytest.mark.slow
def test_vectorized_enc_dec_sweep_smoke():
    """Whole CRN / EDCT seed columns as vmapped two-stage dispatches."""
    import numpy as np
    from insite_tpu.harness.vectorized_neural import vectorized_enc_dec_sweep
    for method in ('crn', 'edct'):
        r = vectorized_enc_dec_sweep(
            method, 'EQ_4_D', n_seeds=2,
            num_patients={'train': 40, 'val': 8, 'test': 6},
            epochs=2, eval_chunk=64)
        assert set(r) >= {'encoder_test_rmse_orig', 'encoder_test_rmse_all',
                          'encoder_test_rmse_last',
                          'decoder_test_rmse_2-step',
                          'decoder_test_rmse_6-step'}, method
        for k, v in r.items():
            assert v.shape == (2,) and np.isfinite(v).all(), (method, k)
            assert (v < 50).all(), (method, k)


@pytest.mark.slow
def test_vectorized_rmsn_sweep_smoke():
    import numpy as np
    from insite_tpu.harness.vectorized_neural import vectorized_rmsn_sweep
    r = vectorized_rmsn_sweep(
        'EQ_4_D', n_seeds=2, num_patients={'train': 40, 'val': 8,
                                           'test': 6},
        epochs=2, eval_chunk=64)
    for k, v in r.items():
        assert v.shape == (2,) and np.isfinite(v).all(), k
        assert (v < 50).all(), k


@pytest.mark.slow
def test_vectorized_gnet_sweep_smoke():
    import numpy as np
    from insite_tpu.harness.vectorized_neural import vectorized_gnet_sweep
    r = vectorized_gnet_sweep(
        'EQ_4_D', n_seeds=2, num_patients={'train': 40, 'val': 8,
                                           'test': 6},
        epochs=2, eval_chunk=64, mc_samples=2)
    for k, v in r.items():
        assert v.shape == (2,) and np.isfinite(v).all(), k
        assert (v < 50).all(), k


@pytest.mark.slow
def test_vectorized_ct_sweep_smoke():
    """Whole CT seed column as one vmapped training dispatch: metric keys,
    per-seed values finite, magnitudes at the untrained-network level for
    2 epochs."""
    import numpy as np
    from insite_tpu.harness.vectorized_neural import vectorized_ct_sweep
    r = vectorized_ct_sweep('EQ_4_D', n_seeds=2,
                            num_patients={'train': 40, 'val': 8, 'test': 6},
                            epochs=2, eval_chunk=16)
    assert set(r) >= {'encoder_test_rmse_orig', 'encoder_test_rmse_all',
                      'encoder_test_rmse_last', 'decoder_test_rmse_2-step',
                      'decoder_test_rmse_6-step'}
    for k, v in r.items():
        assert v.shape == (2,) and np.isfinite(v).all(), k
        assert (v < 50).all(), k


@pytest.mark.slow
def test_vectorized_ct_matches_standard_path():
    """With the rng discipline aligned to CausalTransformer.fit, a
    2-seed stacked vectorized column reproduces each standard per-seed
    path (same cohorts, same init/training rngs; stacked seeds exercise
    the per-seed rng split + row padding the sweep columns rely on)."""
    import numpy as np
    from insite_tpu.data import make_collection
    from insite_tpu.harness.vectorized_neural import vectorized_ct_sweep
    from insite_tpu.models.ct import CTConfig, CausalTransformer

    num_patients = {'train': 40, 'val': 8, 'test': 6}
    r_vec = vectorized_ct_sweep('EQ_4_D', n_seeds=2,
                                num_patients=num_patients, epochs=3,
                                eval_chunk=64)
    for seed in (0, 1):
        np.random.seed(seed)
        coll = make_collection('EQ_4_D', num_patients, seed, coeff=2.0,
                               treatment_mode='multilabel')
        coll.process_data_multi()
        d = coll.train_f.data
        cfg = CTConfig(epochs=3, seed=seed, treatment_mode='multilabel',
                       dim_outcome=d['outputs'].shape[-1],
                       dim_treatments=d['current_treatments'].shape[-1],
                       dim_static_features=d['static_features'].shape[-1])
        m = CausalTransformer(cfg, coll).fit(coll.train_f)
        o, a, l = m.get_normalised_masked_rmse(coll.test_cf_one_step,
                                               one_step_counterfactual=True)
        np.testing.assert_allclose(r_vec['encoder_test_rmse_orig'][seed], o,
                                   rtol=1e-3)
        np.testing.assert_allclose(r_vec['encoder_test_rmse_last'][seed], l,
                                   rtol=1e-3)


def test_vectorized_insight_grid_sweeps():
    """INSIGHT_NOISE / INSIGHT_LESS_SAMPLES as vectorized 10-seed-style
    columns per grid point (runner._vectorized_grid_sweep)."""
    import logging
    from insite_tpu.harness.config import RunConfig
    from insite_tpu.harness.runner import _vectorized_grid_sweep

    log = logging.getLogger('grid_test')
    base = dict(methods=('sindy',), seed_runs=2, train_samples=60,
                test_samples=8, debug_mode=True, metrics_jsonl='')
    df_n, _ = _vectorized_grid_sweep(
        RunConfig(experiment='INSIGHT_NOISE', noise_scales=(0.0, 2.0),
                  **base), log)
    assert len(df_n) == 4 and set(df_n['noise_scale']) == {0.0, 2.0}
    assert np.isfinite(df_n['encoder_test_rmse_orig']).all()
    # more observation noise -> worse discovery fit on average
    g = df_n.groupby('noise_scale')['encoder_test_rmse_orig'].mean()
    assert g[2.0] > g[0.0]

    df_s, _ = _vectorized_grid_sweep(
        RunConfig(experiment='INSIGHT_LESS_SAMPLES',
                  train_sample_grid=(40, 80), **base), log)
    assert len(df_s) == 4 and set(df_s['train_samples']) == {40.0, 80.0}
    assert np.isfinite(df_s['encoder_test_rmse_orig']).all()


def test_vectorized_wsindy_matches_standard():
    """The vectorized weak-form column agrees with the standard-path
    WSINDy at the same workload."""
    from insite_tpu.harness.config import RunConfig
    from insite_tpu.harness.runner import run_experiment
    r_vec = vectorized_eq4_sweep('EQ_4_D', n_seeds=1, n_train=100,
                                 n_test=10, method='wsindy')
    assert np.isfinite(r_vec['encoder_test_rmse_orig']).all()
    cfg = RunConfig(train_samples=100, val_samples=10, test_samples=10)
    r_std = run_experiment('EQ_4_D', 'wsindy', seed=0, domain_conf=2.0,
                           cfg=cfg)
    np.testing.assert_allclose(r_vec['encoder_test_rmse_orig'][0],
                               r_std['encoder_test_rmse_orig'], rtol=0.2)


def test_one_step_dedup_matches_per_row_finetune():
    """On the noise-free EQ_4_A the factual/cf pair of each prefix share
    the ph=1-masked objective EXACTLY, so the per-prefix dedup reproduces
    the per-row path; on noisy variants each row draws its own prefix
    noise and the dedup is only an approximation (the root cause of
    round-1's abandoned dedup — documented in harness/vectorized.py)."""
    kw = dict(n_seeds=2, n_train=60, n_test=6, method='insite')
    r_dedup = vectorized_eq4_sweep('EQ_4_A', dedup_one_step=True, **kw)
    r_perrow = vectorized_eq4_sweep('EQ_4_A', dedup_one_step=False, **kw)
    for k in ('encoder_test_rmse_orig', 'encoder_test_rmse_all',
              'encoder_test_rmse_last'):
        np.testing.assert_allclose(r_dedup[k], r_perrow[k], rtol=1e-5)
    # noisy variant: approximate, same accuracy level
    r_d = vectorized_eq4_sweep('EQ_4_D', dedup_one_step=True, **kw)
    r_p = vectorized_eq4_sweep('EQ_4_D', dedup_one_step=False, **kw)
    np.testing.assert_allclose(r_d['encoder_test_rmse_orig'],
                               r_p['encoder_test_rmse_orig'],
                               rtol=0.3, atol=5e-3)


@pytest.mark.slow
def test_vectorized_rmsn_matches_standard_path():
    """1-seed vectorized RMSN column reproduces the standard per-seed
    path (same cohort, same per-stage rngs, no padding at 1 seed)."""
    import numpy as np
    from insite_tpu.data import make_collection
    from insite_tpu.harness.vectorized_neural import vectorized_rmsn_sweep
    from insite_tpu.models.rmsn import RMSN, RMSNConfig

    num_patients = {'train': 40, 'val': 8, 'test': 6}
    r_vec = vectorized_rmsn_sweep('EQ_4_D', n_seeds=2,
                                  num_patients=num_patients, epochs=2,
                                  eval_chunk=64)
    for seed in (0, 1):
        np.random.seed(seed)
        coll = make_collection('EQ_4_D', num_patients, seed, coeff=2.0,
                               treatment_mode='multilabel')
        coll.process_data_encoder()
        d = coll.train_f.data
        cfg = RMSNConfig(epochs=2, seed=seed, treatment_mode='multilabel',
                         dim_outcome=d['outputs'].shape[-1],
                         dim_treatments=d['current_treatments'].shape[-1],
                         dim_static_features=d['static_features'].shape[-1])
        m = RMSN(cfg, coll).fit()
        o, a, l = m.get_normalised_masked_rmse(coll.test_cf_one_step,
                                               one_step_counterfactual=True)
        np.testing.assert_allclose(r_vec['encoder_test_rmse_orig'][seed], o,
                                   rtol=1e-3)
        np.testing.assert_allclose(r_vec['encoder_test_rmse_last'][seed], l,
                                   rtol=1e-3)


@pytest.mark.slow
def test_vectorized_crn_matches_standard_path():
    """1-seed vectorized CRN column reproduces the standard per-seed
    two-stage path (same cohort, same _Stage rng discipline)."""
    import numpy as np
    from insite_tpu.data import make_collection
    from insite_tpu.harness.vectorized_neural import vectorized_enc_dec_sweep
    from insite_tpu.models.crn import CRN, CRNConfig

    num_patients = {'train': 40, 'val': 8, 'test': 6}
    r_vec = vectorized_enc_dec_sweep('crn', 'EQ_4_D', n_seeds=2,
                                     num_patients=num_patients, epochs=2,
                                     eval_chunk=64)
    for seed in (0, 1):
        np.random.seed(seed)
        coll = make_collection('EQ_4_D', num_patients, seed, coeff=2.0,
                               treatment_mode='multilabel')
        coll.process_data_encoder()
        d = coll.train_f.data
        cfg = CRNConfig(epochs=2, seed=seed, treatment_mode='multilabel',
                        dim_outcome=d['outputs'].shape[-1],
                        dim_treatments=d['current_treatments'].shape[-1],
                        dim_static_features=d['static_features'].shape[-1])
        m = CRN(cfg, coll).fit()
        o, a, l = m.get_normalised_masked_rmse(coll.test_cf_one_step,
                                               one_step_counterfactual=True)
        np.testing.assert_allclose(r_vec['encoder_test_rmse_orig'][seed], o,
                                   rtol=1e-3)
        n_step = np.asarray(
            m.get_normalised_n_step_rmses(coll.test_cf_treatment_seq))
        np.testing.assert_allclose(r_vec['decoder_test_rmse_6-step'][seed],
                                   n_step[-1], rtol=1e-3)


@pytest.mark.slow
def test_vectorized_gnet_matches_standard_path():
    """2-seed stacked vectorized G-Net column reproduces each standard
    per-seed path, incl. the per-seed np.random residual-index draws of
    the MC rollouts (gnet.py get_autoregressive_predictions)."""
    import numpy as np
    from insite_tpu.data import make_collection
    from insite_tpu.harness.vectorized_neural import vectorized_gnet_sweep
    from insite_tpu.models.gnet import GNet, GNetConfig

    num_patients = {'train': 40, 'val': 8, 'test': 6}
    r_vec = vectorized_gnet_sweep('EQ_4_D', n_seeds=2,
                                  num_patients=num_patients, epochs=2,
                                  eval_chunk=64, mc_samples=2)
    for seed in (0, 1):
        np.random.seed(seed)
        coll = make_collection('EQ_4_D', num_patients, seed, coeff=2.0,
                               treatment_mode='multilabel')
        coll.process_data_multi()
        d = coll.train_f.data
        cfg = GNetConfig(epochs=2, seed=seed, mc_samples=2,
                         dim_outcome=d['outputs'].shape[-1],
                         dim_treatments=d['current_treatments'].shape[-1],
                         dim_static_features=d['static_features'].shape[-1])
        m = GNet(cfg, coll)
        m.fit(coll.train_f, coll.val_f)
        o, a, l = m.get_normalised_masked_rmse(coll.test_cf_one_step,
                                               one_step_counterfactual=True)
        np.testing.assert_allclose(r_vec['encoder_test_rmse_orig'][seed], o,
                                   rtol=1e-3)
        n_step = np.asarray(
            m.get_normalised_n_step_rmses(coll.test_cf_treatment_seq))
        np.testing.assert_allclose(r_vec['decoder_test_rmse_6-step'][seed],
                                   n_step[-1], rtol=1e-3)


@pytest.mark.slow
def test_vectorized_edct_matches_standard_path():
    """1-seed vectorized EDCT column reproduces the standard per-seed
    path (incl. the per-row encoder_r gather for decoder training)."""
    import numpy as np
    from insite_tpu.data import make_collection
    from insite_tpu.harness.vectorized_neural import vectorized_enc_dec_sweep
    from insite_tpu.models.edct import EDCT, EDCTConfig

    num_patients = {'train': 40, 'val': 8, 'test': 6}
    r_vec = vectorized_enc_dec_sweep('edct', 'EQ_4_D', n_seeds=2,
                                     num_patients=num_patients, epochs=2,
                                     eval_chunk=64)
    for seed in (0, 1):
        np.random.seed(seed)
        coll = make_collection('EQ_4_D', num_patients, seed, coeff=2.0,
                               treatment_mode='multilabel')
        coll.process_data_encoder()
        d = coll.train_f.data
        cfg = EDCTConfig(epochs=2, seed=seed, treatment_mode='multilabel',
                         dim_outcome=d['outputs'].shape[-1],
                         dim_treatments=d['current_treatments'].shape[-1],
                         dim_static_features=d['static_features'].shape[-1])
        m = EDCT(cfg, coll).fit()
        o, a, l = m.get_normalised_masked_rmse(coll.test_cf_one_step,
                                               one_step_counterfactual=True)
        np.testing.assert_allclose(r_vec['encoder_test_rmse_orig'][seed], o,
                                   rtol=1e-3)
        n_step = np.asarray(
            m.get_normalised_n_step_rmses(coll.test_cf_treatment_seq))
        np.testing.assert_allclose(r_vec['decoder_test_rmse_6-step'][seed],
                                   n_step[-1], rtol=1e-3)


@pytest.mark.slow
def test_vectorized_neural_tumor_family_smoke():
    """The protocol queue's tumor-family columns (cancer_sim / EQ_5) run
    the same vmapped dispatches as EQ_4 but with the 4-class chemo/radio
    treatment layout and tumor scaling — smoke the enc-dec and RMSN
    columns on tiny cohorts so a layout regression surfaces here, not
    first in a 10-seed sweep on the accelerator."""
    import numpy as np
    from insite_tpu.harness.vectorized_neural import (
        vectorized_enc_dec_sweep, vectorized_rmsn_sweep)
    num_patients = {'train': 40, 'val': 8, 'test': 6}
    r = vectorized_enc_dec_sweep('edct', 'cancer_sim', n_seeds=2,
                                 num_patients=num_patients, epochs=2,
                                 eval_chunk=64)
    for k, v in r.items():
        assert v.shape == (2,) and np.isfinite(v).all(), ('edct', k)
        assert (v < 50).all(), ('edct', k)
    r = vectorized_rmsn_sweep('EQ_5_A', n_seeds=2,
                              num_patients=num_patients, epochs=2,
                              eval_chunk=64)
    for k, v in r.items():
        assert v.shape == (2,) and np.isfinite(v).all(), ('rmsn', k)
        assert (v < 50).all(), ('rmsn', k)
