"""Vectorized neural seed sweeps: train a whole seed column of the Causal
Transformer as ONE vmapped XLA dispatch.

The reference trains each (dataset, seed) neural run in its own Lightning
process (run.py:91-131, ~49 s per CT run); here the per-seed training
program (`make_br_train_fn`) is pure in (params, data, rng), so a seed
column becomes `jit(vmap(run))` over stacked cohorts — the tiny per-model
matmuls (hidden 16, seq 65) widen by the seed axis and the
whole column trains in roughly one seed's wall-clock.

Cohorts are the standard per-seed collections (np.random draw-order parity
with the reference); only training/inference is vectorized, so the metrics
are computed with the exact per-seed evaluation protocol
(eval/metrics.py).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from insite_tpu.data import make_collection
from insite_tpu.eval.metrics import (normalised_masked_rmse,
                                     normalised_n_step_rmses)
from insite_tpu.models.ct import _BATCH_KEYS


def _stack_padded(dicts, keys, repeat_pad=False):
    """Stack per-seed data dicts to [S, N_max, ...], padding rows.

    Zero padding (default) keeps padded rows inert under the masked
    training losses. For EVAL stacks pass repeat_pad=True: padded rows
    repeat the seed's last real row, so no row is fully masked (an
    all-zero active_entries row makes every attention position masked —
    a degenerate program a device runtime handled badly on the EDCT
    columns); padded outputs are discarded via the returned row counts
    either way."""
    n_rows = [np.asarray(d[keys[0]]).shape[0] for d in dicts]
    n_max = max(n_rows)
    out = {}
    for k in keys:
        leaves = []
        for d in dicts:
            v = np.asarray(d[k], np.float32)
            pad = n_max - v.shape[0]
            if pad:
                filler = np.repeat(v[-1:], pad, axis=0) if repeat_pad \
                    else np.zeros((pad,) + v.shape[1:], v.dtype)
                v = np.concatenate([v, filler])
            leaves.append(v)
        out[k] = np.stack(leaves)
    return out, n_rows


def _seed_sharding(mesh):
    """NamedSharding that splits the leading (seed) axis over a 1-D mesh,
    replicating every other axis."""
    from jax.sharding import NamedSharding, PartitionSpec
    return NamedSharding(mesh, PartitionSpec(mesh.axis_names[0]))


def _shard_seed_axis(tree, mesh):
    sharding = _seed_sharding(mesh)
    return jax.tree_util.tree_map(
        lambda a: jax.device_put(a, sharding), tree)


def _predict_chunked(predict, params, data, chunk, mesh=None,
                     fetch_every=0, seed_chunk=0):
    """Run a seed-vmapped predict over row chunks of [S, N, ...] arrays.

    The CT attention maps materialize as [S, heads, T, T, N]-shaped
    fusions; at counterfactual-test scale (N ~ 6e4 rows x 10 seeds) one
    whole-set dispatch exceeded a 16 GiB device. Chunks are padded to
    `chunk` rows so exactly one program is compiled; outputs are fetched
    with a single batched device_get. With a `mesh`, chunks are placed
    sharded over the seed axis so each device evaluates only its own
    seeds.

    `fetch_every` > 0 drains the accumulated chunk outputs to the host
    every that-many chunks instead of holding all of them on device for
    one batched fetch — more transfers, but resident device memory stays
    at ~fetch_every chunk outputs (the EDCT columns faulted a 16 GiB
    device with the accumulate-everything default).

    `seed_chunk` > 0 additionally blocks the SEED axis: params and data
    are sliced to `seed_chunk`-seed blocks and evaluated block-serially,
    so resident eval transients shrink by S/seed_chunk on top of the row
    chunking (one extra compile for the block shape, reused across
    blocks). This is the EDCT escape hatch: its seed-vmapped transformer
    eval faulted a 16 GiB device at row chunks 8192/4096/1024 with all 10
    seeds stacked — the [S, chunk, T, T] attention transients sit on top
    of both stages' training buffers. Ignored under a `mesh` (the mesh
    path shards the seed axis across devices instead).

    `predict` may return one array or any pytree of [S, rows, ...] arrays
    (e.g. (outcome, br) tuples); chunks are concatenated per leaf.
    """
    n_seeds = next(iter(data.values())).shape[0]
    if seed_chunk and seed_chunk < n_seeds and mesh is None:
        blocks = []
        for s0 in range(0, n_seeds, seed_chunk):
            s1 = min(s0 + seed_chunk, n_seeds)
            p_blk = jax.tree_util.tree_map(lambda a: a[s0:s1], params)
            d_blk = {k: v[s0:s1] for k, v in data.items()}
            blocks.append(_predict_chunked(predict, p_blk, d_blk, chunk))
        return jax.tree_util.tree_map(
            lambda *xs: np.concatenate(xs, axis=0), *blocks)
    n = next(iter(data.values())).shape[1]
    chunk = min(chunk, n)
    outs, fetched = [], []
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        piece = {}
        for k, v in data.items():
            p = v[:, start:end]
            if end - start < chunk:
                # repeat the last row rather than zero-fill: an all-zero
                # row is fully attention-masked (degenerate program); the
                # padded outputs are sliced off right below either way
                pad = np.repeat(p[:, -1:], chunk - (end - start), axis=1)
                p = np.concatenate([p, pad], axis=1)
            piece[k] = jnp.asarray(p) if mesh is None else \
                jax.device_put(p, _seed_sharding(mesh))
        outs.append(jax.tree_util.tree_map(lambda o: o[:, :end - start],
                                           predict(params, piece)))
        if fetch_every and len(outs) >= fetch_every:
            fetched.extend(jax.device_get(outs))
            outs = []
    fetched.extend(jax.device_get(outs))
    return jax.tree_util.tree_map(
        lambda *xs: np.concatenate(xs, axis=1), *fetched)


def _stage_rngs(seeds):
    """Replicate the per-stage rng discipline of crn._Stage.fit_stage
    (rng = PRNGKey(seed); rng, init_rng = split(rng); init with
    {'params': init_rng, 'dropout': rng}; train with rng), one row per
    seed: returns (init_rngs [S,..], carry_rngs [S,..])."""
    base = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    pair = jax.vmap(jax.random.split)(base)          # [S, 2, key]
    return pair[:, 1], pair[:, 0]


def _fit_br_stage(net, stacked_train, tc, seeds, mesh=None,
                  seed_serial=False):
    """Init + train one BR stage (VariationalLSTM/transformer +
    BRTreatmentOutcomeHead) for a whole seed column as ONE vmapped
    two-optimizer dispatch.  Returns (pred_params, predict) where
    ``predict(params, batch) -> (outcome, br)`` is seed-vmapped and
    jitted.  `stacked_train` is the [S, N, ...] data dict (already
    placed/sharded by the caller).

    ``seed_serial=True`` runs the column fit as a HOST loop over one
    jitted S=1 executable (compile paid once, reused for every seed): the
    per-seed program is the literal proven standard-path program, with no
    vmap/scan wrapper around the two-optimizer training loop at all.
    This is the EDCT decoder-stage workaround: on an earlier 16 GiB
    accelerator both the *vmapped* column fit (at 10, 5 and 2 stacked
    seeds) and a ``lax.map`` over the seed axis faulted the device, so the
    failure was the wrapped mega-program itself (epochs-scan x
    batches-scan inside a seed scan), not the training transients'
    footprint.  Not yet re-run on an 80 GB card (ROADMAP design item 3).
    Ignored under a `mesh` (the mesh path shards the seed axis across
    devices)."""
    from insite_tpu.models.nn.training import (make_br_train_fn,
                                               merge_by_mask,
                                               treatment_head_mask)

    def apply_fn(p, batch, alpha, train_flag, rngs_, detach):
        return net.apply({'params': p}, batch, alpha, train_flag, detach,
                         rngs=rngs_)

    sample = jax.tree_util.tree_map(lambda a: a[0, :2], stacked_train)
    init_rngs, carry_rngs = _stage_rngs(seeds)
    if mesh is not None:
        init_rngs = _shard_seed_axis(init_rngs, mesh)
        carry_rngs = _shard_seed_axis(carry_rngs, mesh)

    def init_one(ir, dr):
        return net.init({'params': ir, 'dropout': dr}, sample, 0.0, False,
                        False)['params']

    params = jax.jit(jax.vmap(init_one))(init_rngs, carry_rngs)
    mask = treatment_head_mask(
        jax.tree_util.tree_map(lambda a: a[0], params))
    run = make_br_train_fn(apply_fn, tc, mask)
    if seed_serial and mesh is None:
        run_one = jax.jit(run)
        outs = []
        for s in range(len(seeds)):
            take = jax.tree_util.tree_map(lambda a: a[s], (
                params, stacked_train, carry_rngs))
            outs.append(run_one(*take))
        params, ema = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *outs)
    else:
        params, ema = jax.jit(jax.vmap(run))(params, stacked_train,
                                             carry_rngs)
    pred_params = merge_by_mask(params, ema, mask) if tc.weights_ema \
        else params

    predict = jax.jit(jax.vmap(
        lambda p, b: apply_fn(p, b, 0.0, False, None, False)[1:3]))
    return pred_params, predict


class _ArrayEncoder:
    """Stand-in encoder for process_data_decoder: representations and
    predictions precomputed by the vectorized column, keyed by dataset
    object."""

    def __init__(self):
        self._r, self._p = {}, {}

    def put(self, ds, representations, predictions=None):
        self._r[id(ds)] = representations
        if predictions is not None:
            self._p[id(ds)] = predictions

    def get_representations(self, ds):
        return self._r[id(ds)]

    def get_predictions(self, ds):
        return self._p[id(ds)]


def vectorized_ct_sweep(dataset_name: str, n_seeds: int = 10,
                        num_patients: dict = None, coeff: float = 2.0,
                        epochs: int = 100, seed_start: int = 0,
                        eval_chunk: int = 4096, mesh=None,
                        cf_seq_mode: str = 'sliding_treatment',
                        noise_scale: float = 1.0,
                        model_overrides: dict = None,
                        max_seq_length: int = 60) -> dict:
    """Train + evaluate CT for `n_seeds` seeds in one vmapped program.

    Returns {'encoder_test_rmse_orig'/'all'/'last': [S],
             'decoder_test_rmse_<k>-step': [S]} — the same metric keys as
    run_experiment, one value per seed.

    With a `mesh` (1-D device mesh, `parallel.batch_mesh()`), the seed
    axis of the stacked cohorts, params, and RNGs is sharded over the
    devices: seeds' training programs are independent, so the column
    needs no collectives on the training path.
    n_seeds must be a multiple of the mesh size.
    """
    from insite_tpu.models.ct import CTConfig, CTNetwork, ct_train_config
    from insite_tpu.models.nn.training import (make_br_train_fn,
                                               merge_by_mask,
                                               treatment_head_mask)
    num_patients = num_patients or {'train': 1000, 'val': 100, 'test': 100}

    # --- per-seed cohorts (standard path: reference draw-order parity) ----
    colls = []
    for seed in range(seed_start, seed_start + n_seeds):
        np.random.seed(seed)
        coll = make_collection(dataset_name, num_patients, seed,
                               coeff=float(coeff),
                               treatment_mode='multilabel',
                               cf_seq_mode=cf_seq_mode,
                               noise_scale=noise_scale,
                               max_seq_length=max_seq_length)
        coll.process_data_multi()
        colls.append(coll)

    d = colls[0].train_f.data
    cfg = CTConfig(epochs=epochs,
                   dim_outcome=d['outputs'].shape[-1],
                   dim_treatments=d['current_treatments'].shape[-1],
                   dim_static_features=d['static_features'].shape[-1],
                   treatment_mode='multilabel',
                   **(model_overrides or {}))
    net = CTNetwork(cfg)

    if mesh is not None:
        assert n_seeds % mesh.devices.size == 0, \
            'n_seeds must be a multiple of the mesh size'

    train, _ = _stack_padded([c.train_f.data for c in colls], _BATCH_KEYS)
    train = {k: jnp.asarray(v) for k, v in train.items()} if mesh is None \
        else _shard_seed_axis(train, mesh)

    # --- per-seed init + one vmapped training dispatch --------------------
    # rng discipline matches CausalTransformer.fit exactly (rng =
    # PRNGKey(seed); rng, init_rng = split; init with init_rng + rng; train
    # with rng), so a vectorized column reproduces the standard per-seed
    # path up to vmap reduction order
    sample = jax.tree_util.tree_map(lambda a: a[0, :2], train)
    init_rngs, carry_rngs = _stage_rngs(
        range(seed_start, seed_start + n_seeds))
    if mesh is not None:
        init_rngs = _shard_seed_axis(init_rngs, mesh)
        carry_rngs = _shard_seed_axis(carry_rngs, mesh)

    def init_one(ir, dr):
        return net.init({'params': ir, 'dropout': dr}, sample,
                        0.0, False, False)['params']

    params = jax.jit(jax.vmap(init_one))(init_rngs, carry_rngs)
    mask = treatment_head_mask(
        jax.tree_util.tree_map(lambda a: a[0], params))

    tc = ct_train_config(cfg)

    def apply_fn(p, batch, alpha, train_flag, rngs_, detach):
        return net.apply({'params': p}, batch, alpha, train_flag, detach,
                         rngs=rngs_)

    run = make_br_train_fn(apply_fn, tc, mask)
    params, ema = jax.jit(jax.vmap(run))(params, train, carry_rngs)
    # EMA weights for the non-treatment partition (predict_step,
    # time_varying_model.py:599-608); works on stacked trees
    pred_params = merge_by_mask(params, ema, mask) if cfg.weights_ema \
        else params

    predict = jax.jit(jax.vmap(
        lambda p, b: apply_fn(p, b, 0.0, False, None, False)[1]))

    # --- 1-step eval (exact per-seed metric on unpadded rows) -------------
    one_step, n_rows = _stack_padded(
        [c.test_cf_one_step.data for c in colls], _BATCH_KEYS)
    preds = _predict_chunked(predict, pred_params, one_step, eval_chunk,
                             mesh=mesh)
    res = {'encoder_test_rmse_orig': [], 'encoder_test_rmse_all': [],
           'encoder_test_rmse_last': []}
    for s, c in enumerate(colls):
        o, a, l = normalised_masked_rmse(c.test_cf_one_step,
                                         preds[s, :n_rows[s]],
                                         one_step_counterfactual=True)
        res['encoder_test_rmse_orig'].append(o)
        res['encoder_test_rmse_all'].append(a)
        res['encoder_test_rmse_last'].append(l)

    # --- n-step eval: the CT rolling-origin loop (ct.py:187-203) with a
    # seed axis — predictions written into prev_outputs at each seed's own
    # future_past_split ----------------------------------------------------
    ph = cfg.projection_horizon
    seq_sets = [c.test_cf_treatment_seq for c in colls]
    seq, seq_rows = _stack_padded([t.data for t in seq_sets], _BATCH_KEYS)
    split = np.stack([
        np.pad(np.asarray(t.data['future_past_split']).astype(int),
               (0, seq['outputs'].shape[1] - len(t.data['future_past_split'])),
               constant_values=1)
        for t in seq_sets])
    S, N = split.shape
    s_idx = np.arange(S)[:, None]
    n_idx = np.arange(N)[None, :]
    predicted = np.zeros((S, N, ph, cfg.dim_outcome), np.float32)
    for t in range(ph + 1):
        out = _predict_chunked(predict, pred_params, seq, eval_chunk,
                                mesh=mesh)
        if t < ph:
            seq['prev_outputs'][s_idx, n_idx, split + t, :] = \
                out[s_idx, n_idx, split - 1 + t, :]
        if t > 0:
            predicted[:, :, t - 1, :] = out[s_idx, n_idx, split - 1 + t, :]
    for s, t_set in enumerate(seq_sets):
        rmses = normalised_n_step_rmses(t_set, predicted[s, :seq_rows[s]])
        for k, v in enumerate(np.asarray(rmses)):
            res.setdefault(f'decoder_test_rmse_{k + 2}-step',
                           []).append(float(v))
    return {k: np.asarray(v) for k, v in res.items()}


def _one_step_metrics(res, colls, preds, n_rows):
    for s, c in enumerate(colls):
        o, a, l = normalised_masked_rmse(c.test_cf_one_step,
                                         preds[s, :n_rows[s]],
                                         one_step_counterfactual=True)
        res['encoder_test_rmse_orig'].append(o)
        res['encoder_test_rmse_all'].append(a)
        res['encoder_test_rmse_last'].append(l)


def _n_step_metrics(res, colls, predicted, n_rows):
    for s, c in enumerate(colls):
        rmses = normalised_n_step_rmses(c.test_cf_treatment_seq,
                                        predicted[s, :n_rows[s]])
        for k, v in enumerate(np.asarray(rmses)):
            res.setdefault(f'decoder_test_rmse_{k + 2}-step',
                           []).append(float(v))


def vectorized_enc_dec_sweep(method: str, dataset_name: str,
                             n_seeds: int = 10, num_patients: dict = None,
                             coeff: float = 2.0, epochs: int = 100,
                             seed_start: int = 0, eval_chunk: int = 4096,
                             mesh=None,
                             cf_seq_mode: str = 'sliding_treatment',
                             noise_scale: float = 1.0,
                             model_overrides: dict = None,
                             max_seq_length: int = 60,
                             seed_block: int = None) -> dict:
    """Train + evaluate a whole CRN or EDCT seed column with the two
    stage fits (encoder, decoder) each ONE vmapped dispatch.

    Pipeline (same as the standard CRN/EDCT path, seed-stacked):
      1. per-seed collections, process_data_encoder
      2. encoder column:  jit(vmap(two-optimizer BR fit))
      3. encoder representations (seed-vmapped, chunked) feed each seed's
         process_data_decoder on host (rolling-origin rows, init states)
      4. decoder column:  jit(vmap(...)) over the seed-stacked exploded
         rows — per-seed row counts differ, so short seeds are zero-row
         padded (active_entries = 0 rows contribute nothing to the masked
         losses; they only dilute a seed's effective batch count)
      5. exact per-seed evaluation protocol (1-step encoder RMSE +
         autoregressive decoder n-step).

    Returns the same metric keys as run_experiment, one value per seed.

    ``eval_chunk`` bounds the rows per seed-vmapped predict dispatch; the
    encoder pass over the exploded decoder-training set is the memory
    peak of the whole column ([S, chunk, T, T] attention transients on
    top of the training buffers) — 4096 kept 10-seed columns inside a
    16 GiB device (8192 faulted it on EQ_4_B).

    ``seed_block`` splits the column into independent sub-columns of at
    most that many seeds, run serially in-process and concatenated. Seeds
    never couple (per-seed cohorts, per-seed rngs from _stage_rngs), so a
    blocked column lands row-identical results to the whole column while
    dividing every resident training buffer by S/seed_block. No longer
    needed for EDCT: its DECODER stage fit (exploded rolling-origin rows
    x cross-attention, the largest program of the column) faulted a
    16 GiB device when *vmapped* at 10, 5 AND 2 stacked seeds even with
    seed-serial eval (seed_chunk=1 — the encoder fit and the S=1 eval
    executable had both run clean, isolating the decoder column fit),
    and a ``lax.map``-over-seeds rewrite of the fit faulted identically,
    so the decoder fit now runs as a HOST loop over one jitted S=1 executable
    (`_fit_br_stage(seed_serial=True)`): the per-seed program is the
    proven standard-path program with no device-side wrapper, compile
    reused across seeds.
    """
    assert method in ('crn', 'edct')
    if seed_block and 0 < seed_block < n_seeds and mesh is None:
        parts = []
        for b0 in range(0, n_seeds, seed_block):
            parts.append(vectorized_enc_dec_sweep(
                method, dataset_name,
                n_seeds=min(seed_block, n_seeds - b0),
                num_patients=num_patients, coeff=coeff, epochs=epochs,
                seed_start=seed_start + b0, eval_chunk=eval_chunk,
                mesh=mesh, cf_seq_mode=cf_seq_mode,
                noise_scale=noise_scale, model_overrides=model_overrides,
                max_seq_length=max_seq_length, seed_block=0))
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    fetch_every = 0
    seed_chunk = 0
    if method == 'edct':
        # the EDCT transformer's seed-vmapped eval faulted a 16 GiB
        # device at row chunks 8192, 4096 AND 1024 with 10 stacked seeds
        # (the [S, chunk, T, T] attention transients ride on top of both
        # stages' resident training buffers) — evaluate seed-serially
        # instead: 10x less resident eval memory, one extra S=1 compile,
        # row chunk can stay large to keep dispatches few
        seed_chunk = 1
    num_patients = num_patients or {'train': 1000, 'val': 100, 'test': 100}
    seeds = list(range(seed_start, seed_start + n_seeds))
    if mesh is not None:
        assert n_seeds % mesh.devices.size == 0, \
            'n_seeds must be a multiple of the mesh size'

    colls = []
    for seed in seeds:
        np.random.seed(seed)
        coll = make_collection(dataset_name, num_patients, seed,
                               coeff=float(coeff),
                               treatment_mode='multilabel',
                               cf_seq_mode=cf_seq_mode,
                               noise_scale=noise_scale,
                               max_seq_length=max_seq_length)
        coll.process_data_encoder()
        colls.append(coll)

    d = colls[0].train_f.data
    dims = dict(dim_outcome=d['outputs'].shape[-1],
                dim_treatments=d['current_treatments'].shape[-1],
                dim_static_features=d['static_features'].shape[-1])
    if method == 'crn':
        from insite_tpu.models import crn as fam
        cfg = fam.CRNConfig(epochs=epochs, treatment_mode='multilabel',
                            **dims, **(model_overrides or {}))
        model = fam.CRN(cfg, colls[0])
    else:
        from insite_tpu.models import edct as fam
        cfg = fam.EDCTConfig(epochs=epochs, treatment_mode='multilabel',
                             **dims, **(model_overrides or {}))
        model = fam.EDCT(cfg, colls[0])
    enc, dec = model.encoder, model.decoder
    ph, do = cfg.projection_horizon, cfg.dim_outcome

    def place(tree):
        return {k: jnp.asarray(v) for k, v in tree.items()} \
            if mesh is None else _shard_seed_axis(tree, mesh)

    # ---- stage 1: encoder column ----------------------------------------
    enc_train, _ = _stack_padded([c.train_f.data for c in colls], enc.keys)
    enc_params, enc_predict = _fit_br_stage(enc.net, place(enc_train),
                                            enc.train_cfg, seeds, mesh=mesh)

    # ---- encoder outputs feed the per-seed decoder processing -----------
    save_r = (method == 'edct')
    shims = [_ArrayEncoder() for _ in seeds]
    for subset in ('train_f', 'val_f', 'test_cf_treatment_seq'):
        ds_list = [getattr(c, subset) for c in colls]
        # decoder processing needs the subset processed first (the standard
        # process_data_decoder order)
        for c, ds in zip(colls, ds_list):
            c._process(ds)
        stacked, rows = _stack_padded([ds.data for ds in ds_list],
                                      enc.input_keys, repeat_pad=True)
        op, br = _predict_chunked(enc_predict, enc_params, stacked,
                                  eval_chunk, mesh=mesh,
                                  fetch_every=fetch_every,
                                  seed_chunk=seed_chunk)
        for s, ds in enumerate(ds_list):
            shims[s].put(ds, br[s, :rows[s]], op[s, :rows[s]])
    for c, shim in zip(colls, shims):
        c.process_data_decoder(shim, save_encoder_r=save_r)

    # ---- stage 2: decoder column ----------------------------------------
    dec_train_list = []
    for c in colls:
        td = {k: np.asarray(c.train_f.data[k]) for k in dec.keys
              if k != 'encoder_r'}
        if method == 'edct':
            orig = c.train_f.data['original_index'].astype(int)
            td['encoder_r'] = np.asarray(c.train_f.encoder_r)[orig]
        dec_train_list.append(td)
    dec_train, _ = _stack_padded(dec_train_list, list(dec_train_list[0]))
    dec_seeds = [s + 1 for s in seeds]       # crn.py: decoder seed = seed+1
    dec_params, dec_predict = _fit_br_stage(dec.net, place(dec_train),
                                            dec.train_cfg, dec_seeds,
                                            mesh=mesh,
                                            seed_serial=(method == 'edct'))

    # ---- 1-step eval (encoder, exact per-seed metric) -------------------
    res = {'encoder_test_rmse_orig': [], 'encoder_test_rmse_all': [],
           'encoder_test_rmse_last': []}
    one_step, n_rows = _stack_padded(
        [c.test_cf_one_step.data for c in colls], enc.input_keys,
        repeat_pad=True)
    op, _ = _predict_chunked(enc_predict, enc_params, one_step, eval_chunk,
                             mesh=mesh, fetch_every=fetch_every,
                             seed_chunk=seed_chunk)
    _one_step_metrics(res, colls, op, n_rows)

    # ---- n-step eval (autoregressive decoder, crn.py:212-224) -----------
    ar_list = []
    for c in colls:
        ds = c.test_cf_treatment_seq
        ad = {k: np.array(ds.data[k]) for k in dec.input_keys
              if k != 'encoder_r'}
        if method == 'edct':
            ad['encoder_r'] = np.array(ds.encoder_r)
        ar_list.append(ad)
    ar, ar_rows = _stack_padded(ar_list, list(ar_list[0]),
                                repeat_pad=True)
    predicted = np.zeros((n_seeds, ar['prev_outputs'].shape[1], ph, do),
                         np.float32)
    for t in range(ph):
        out, _ = _predict_chunked(dec_predict, dec_params, ar, eval_chunk,
                                  mesh=mesh, fetch_every=fetch_every,
                                  seed_chunk=seed_chunk)
        predicted[:, :, t] = out[:, :, t]
        if t < ph - 1:
            ar['prev_outputs'][:, :, t + 1, :] = out[:, :, t, :]
    _n_step_metrics(res, colls, predicted, ar_rows)
    return {k: np.asarray(v) for k, v in res.items()}


def _fit_simple_column(net, data_list, loss_builder, tc, stage_seeds,
                       mesh=None, has_init_state=False, lstm_style=True):
    """Fit one RMSN/G-Net-style sub-network for a whole seed column as ONE
    vmapped single-optimizer dispatch.  Each ``data_list[s]`` must contain
    'x' plus the loss extras; rows are zero-padded to the column max
    (inert under the masked losses).

    `lstm_style=True` targets rmsn.LSTMOutputNet's
    ``__call__(x, init_state, train) -> (out, hidden)``; False targets
    G-Net's ``__call__(x, train) -> out`` (hidden echoed as out).
    Returns (stacked_params, predict) with
    ``predict(params, {'x'[, 'init_state']}) -> (out, hidden)``."""
    from insite_tpu.models.nn.training import make_simple_train_fn

    stacked, _ = _stack_padded(data_list, list(data_list[0]))
    stacked = {k: jnp.asarray(v) for k, v in stacked.items()} \
        if mesh is None else _shard_seed_axis(stacked, mesh)
    init_rngs, carry_rngs = _stage_rngs(stage_seeds)
    if mesh is not None:
        init_rngs = _shard_seed_axis(init_rngs, mesh)
        carry_rngs = _shard_seed_axis(carry_rngs, mesh)
    sample_x = stacked['x'][0, :2]
    sample_init = stacked['init_state'][0, :2] if has_init_state else None

    def net_apply(p, x, init_state, train, rngs=None):
        if lstm_style:
            return net.apply({'params': p}, x, init_state, train, rngs=rngs)
        out = net.apply({'params': p}, x, train, rngs=rngs)
        return out, out

    def init_one(ir, dr):
        rngs = {'params': ir, 'dropout': dr}
        if lstm_style:
            return net.init(rngs, sample_x, sample_init, False)['params']
        return net.init(rngs, sample_x, False)['params']

    params = jax.jit(jax.vmap(init_one))(init_rngs, carry_rngs)

    def loss_fn(p, batch, rngs):
        out, _ = net_apply(p, batch['x'], batch.get('init_state'), True,
                           rngs=rngs)
        return loss_builder(out, batch)

    run = make_simple_train_fn(loss_fn, tc, stacked['x'].shape[1])
    params = jax.jit(jax.vmap(run))(params, stacked, carry_rngs)
    predict = jax.jit(jax.vmap(
        lambda p, b: net_apply(p, b['x'], b.get('init_state'), False)))
    return params, predict


def vectorized_rmsn_sweep(dataset_name: str, n_seeds: int = 10,
                          num_patients: dict = None, coeff: float = 2.0,
                          epochs: int = 100, seed_start: int = 0,
                          eval_chunk: int = 8192, mesh=None,
                          cf_seq_mode: str = 'sliding_treatment',
                          noise_scale: float = 1.0,
                          model_overrides: dict = None,
                          max_seq_length: int = 60) -> dict:
    """Train + evaluate a whole RMSN seed column: the four sub-network
    fits (propensity-treatment, propensity-history, SW-weighted encoder,
    SW-weighted decoder) each run as ONE vmapped dispatch; stabilized
    weights and decoder-row processing stay the exact per-seed host path
    (models/rmsn.py:186-262)."""
    from insite_tpu.models import rmsn as fam
    from insite_tpu.models.nn.blocks import bce
    from insite_tpu.models.nn.training import TrainConfig, masked_mean

    num_patients = num_patients or {'train': 1000, 'val': 100, 'test': 100}
    seeds = list(range(seed_start, seed_start + n_seeds))
    if mesh is not None:
        assert n_seeds % mesh.devices.size == 0, \
            'n_seeds must be a multiple of the mesh size'

    colls = []
    for seed in seeds:
        np.random.seed(seed)
        coll = make_collection(dataset_name, num_patients, seed,
                               coeff=float(coeff),
                               treatment_mode='multilabel',
                               cf_seq_mode=cf_seq_mode,
                               noise_scale=noise_scale,
                               max_seq_length=max_seq_length)
        coll.process_data_encoder()
        colls.append(coll)

    d = colls[0].train_f.data
    dims = dict(dim_outcome=d['outputs'].shape[-1],
                dim_treatments=d['current_treatments'].shape[-1],
                dim_static_features=d['static_features'].shape[-1])
    cfg = fam.RMSNConfig(epochs=epochs, treatment_mode='multilabel',
                         **dims, **(model_overrides or {}))
    m = fam.RMSN(cfg, colls[0])       # net definitions + input assemblers
    ph_steps, do = cfg.projection_horizon, cfg.dim_outcome
    mode = cfg.treatment_mode

    def bce_builder(out, batch):
        elem = bce(out, batch['current_treatments'], mode)
        return masked_mean(elem, batch['active_entries'][..., 0])

    def wmse_builder(out, batch):
        mse = (out - batch['outputs']) ** 2 * batch['sw'][..., None]
        return masked_mean(mse, batch['active_entries'])

    def extras(data, *keys):
        return {k: np.asarray(data[k]) for k in keys}

    # ---- propensity columns ---------------------------------------------
    train_datas = [c.train_f.data for c in colls]
    pt_params, pt_predict = _fit_simple_column(
        m.prop_treat,
        [{'x': m._propensity_inputs_treat(td),
          **extras(td, 'current_treatments', 'active_entries')}
         for td in train_datas],
        bce_builder,
        TrainConfig(cfg.epochs, cfg.prop_treat_bs, cfg.prop_treat_lr,
                    max_grad_norm=cfg.prop_treat_clip),
        seeds, mesh=mesh)
    ph_params, ph_predict = _fit_simple_column(
        m.prop_hist,
        [{'x': m._propensity_inputs_hist(td),
          **extras(td, 'current_treatments', 'active_entries')}
         for td in train_datas],
        bce_builder,
        TrainConfig(cfg.epochs, cfg.prop_hist_bs, cfg.prop_hist_lr,
                    max_grad_norm=cfg.prop_hist_clip),
        [s + 1 for s in seeds], mesh=mesh)

    # ---- stabilized weights (exact per-seed host path) ------------------
    pt_in, _ = _stack_padded([{'x': m._propensity_inputs_treat(td)}
                              for td in train_datas], ['x'])
    ph_in, _ = _stack_padded([{'x': m._propensity_inputs_hist(td)}
                              for td in train_datas], ['x'])
    pt_scores = jax.nn.sigmoid(
        _predict_chunked(pt_predict, pt_params, pt_in, eval_chunk,
                         mesh=mesh)[0])
    ph_scores = jax.nn.sigmoid(
        _predict_chunked(ph_predict, ph_params, ph_in, eval_chunk,
                         mesh=mesh)[0])
    pt_scores, ph_scores = np.asarray(pt_scores), np.asarray(ph_scores)
    for s, td in enumerate(train_datas):
        a = np.asarray(td['current_treatments'])
        if cfg.sw_mode == 'likelihood':
            eps = 1e-6
            lik_t = np.clip(a * pt_scores[s] + (1 - a) * (1 - pt_scores[s]),
                            eps, None)
            lik_h = np.clip(a * ph_scores[s] + (1 - a) * (1 - ph_scores[s]),
                            eps, None)
            td['stabilized_weights'] = np.prod(lik_t / lik_h, axis=2)
        else:                              # score_ratio reference parity
            td['stabilized_weights'] = \
                np.prod(pt_scores[s] / ph_scores[s], axis=2)
        td['sw_tilde_enc'] = fam.clip_normalize_stabilized_weights(
            td['stabilized_weights'], td['active_entries'])

    # ---- SW-weighted encoder column -------------------------------------
    enc_params, enc_predict = _fit_simple_column(
        m.encoder,
        [{'x': m._encoder_inputs(td),
          **extras(td, 'outputs', 'active_entries'),
          'sw': td['sw_tilde_enc']} for td in train_datas],
        wmse_builder,
        TrainConfig(cfg.epochs * cfg.enc_epoch_mult, cfg.enc_bs, cfg.enc_lr,
                    max_grad_norm=cfg.enc_clip),
        [s + 2 for s in seeds], mesh=mesh)

    # ---- decoder rows (per-seed host processing) ------------------------
    shims = [_ArrayEncoder() for _ in seeds]
    for subset in ('train_f', 'val_f', 'test_cf_treatment_seq'):
        ds_list = [getattr(c, subset) for c in colls]
        for c, ds in zip(colls, ds_list):
            c._process(ds)
        stacked, rows = _stack_padded(
            [{'x': m._encoder_inputs(ds.data)} for ds in ds_list], ['x'])
        out, hidden = _predict_chunked(enc_predict, enc_params, stacked,
                                       eval_chunk, mesh=mesh)
        for s, ds in enumerate(ds_list):
            shims[s].put(ds, hidden[s, :rows[s]], out[s, :rows[s]])
    for c, shim in zip(colls, shims):
        c.process_data_decoder(shim)

    dec_list = []
    for c in colls:
        dd = c.train_f.data
        sw = np.cumprod(dd['stabilized_weights'], axis=-1)[:, 1:]
        dd['sw_tilde_dec'] = fam.clip_normalize_stabilized_weights(
            sw, dd['active_entries'], multiple_horizons=True)
        dec_list.append({'x': m._decoder_inputs(dd),
                         **extras(dd, 'outputs', 'active_entries',
                                  'init_state'),
                         'sw': dd['sw_tilde_dec']})
    dec_params, dec_predict = _fit_simple_column(
        m.decoder, dec_list, wmse_builder,
        TrainConfig(cfg.epochs, cfg.dec_bs, cfg.dec_lr,
                    max_grad_norm=cfg.dec_clip),
        [s + 3 for s in seeds], mesh=mesh, has_init_state=True)

    # ---- 1-step eval (encoder) ------------------------------------------
    res = {'encoder_test_rmse_orig': [], 'encoder_test_rmse_all': [],
           'encoder_test_rmse_last': []}
    one_step, n_rows = _stack_padded(
        [{'x': m._encoder_inputs(c.test_cf_one_step.data)} for c in colls],
        ['x'])
    op, _ = _predict_chunked(enc_predict, enc_params, one_step, eval_chunk,
                             mesh=mesh)
    _one_step_metrics(res, colls, op, n_rows)

    # ---- n-step eval (autoregressive decoder, rmsn.py:299-316) ----------
    ar_keys = ('prev_treatments', 'prev_outputs', 'static_features',
               'current_treatments', 'init_state')
    ar, ar_rows = _stack_padded(
        [{k: np.array(c.test_cf_treatment_seq.data[k]) for k in ar_keys}
         for c in colls], list(ar_keys))
    predicted = np.zeros((n_seeds, ar['prev_outputs'].shape[1], ph_steps,
                          do), np.float32)
    for t in range(ph_steps):
        T = ar['prev_outputs'].shape[2]
        statics = np.repeat(ar['static_features'][:, :, None, :], T, axis=2)
        x = np.concatenate([ar['current_treatments'], ar['prev_outputs'],
                            statics], axis=-1)
        out, _ = _predict_chunked(dec_predict, dec_params,
                                  {'x': x, 'init_state': ar['init_state']},
                                  eval_chunk, mesh=mesh)
        predicted[:, :, t] = out[:, :, t]
        if t < ph_steps - 1:
            ar['prev_outputs'][:, :, t + 1, :] = out[:, :, t, :]
    _n_step_metrics(res, colls, predicted, ar_rows)
    return {k: np.asarray(v) for k, v in res.items()}


def vectorized_gnet_sweep(dataset_name: str, n_seeds: int = 10,
                          num_patients: dict = None, coeff: float = 2.0,
                          epochs: int = 100, seed_start: int = 0,
                          eval_chunk: int = 8192, mc_samples: int = 25,
                          mesh=None,
                          cf_seq_mode: str = 'sliding_treatment',
                          noise_scale: float = 1.0,
                          model_overrides: dict = None,
                          max_seq_length: int = 60) -> dict:
    """Train + evaluate a whole G-Net seed column: the representation-net
    fit is ONE vmapped dispatch and the MC-noisy autoregressive rollouts
    run seed-vmapped in row chunks (models/gnet.py)."""
    from insite_tpu.models import gnet as fam
    from insite_tpu.models.nn.training import TrainConfig, masked_mean

    num_patients = num_patients or {'train': 1000, 'val': 100, 'test': 100}
    seeds = list(range(seed_start, seed_start + n_seeds))
    if mesh is not None:
        assert n_seeds % mesh.devices.size == 0, \
            'n_seeds must be a multiple of the mesh size'

    d0 = None
    colls = []
    for seed in seeds:
        np.random.seed(seed)
        coll = make_collection(dataset_name, num_patients, seed,
                               coeff=float(coeff),
                               treatment_mode='multilabel',
                               cf_seq_mode=cf_seq_mode,
                               noise_scale=noise_scale,
                               max_seq_length=max_seq_length)
        coll.process_data_multi()
        colls.append(coll)
        d0 = d0 or coll.train_f.data
    dims = dict(dim_outcome=d0['outputs'].shape[-1],
                dim_treatments=d0['current_treatments'].shape[-1],
                dim_static_features=d0['static_features'].shape[-1])
    cfg = fam.GNetConfig(epochs=epochs, mc_samples=mc_samples, **dims,
                         **(model_overrides or {}))
    net = fam.GNetNetwork(cfg)
    ph, do = cfg.projection_horizon, cfg.dim_outcome
    for c in colls:
        c.split_train_f_holdout(cfg.holdout_ratio)

    def mse_builder(out, batch):
        mse = (out[..., :do] - batch['outputs']) ** 2
        return masked_mean(mse, batch['active_entries'])

    params, predict = _fit_simple_column(
        net,
        [{'x': fam._inputs(c.train_f.data),
          'outputs': np.asarray(c.train_f.data['outputs']),
          'active_entries': np.asarray(c.train_f.data['active_entries'])}
         for c in colls],
        mse_builder,
        TrainConfig(cfg.epochs, cfg.batch_size, cfg.learning_rate),
        seeds, mesh=mesh, lstm_style=False)

    def predict_outputs(data_list):
        stacked, rows = _stack_padded(data_list, ['x'])
        out, _ = _predict_chunked(predict, params, stacked, eval_chunk,
                                  mesh=mesh)
        return out[..., :do], rows

    # ---- holdout residual noise bank (gnet.py:104-113) -------------------
    hold = [c.train_f_holdout.data for c in colls]
    hold_pred, _ = predict_outputs([{'x': fam._inputs(h)} for h in hold])
    resid_bank = np.stack([np.asarray(h['outputs']) for h in hold]) \
        - hold_pred                                        # [S, H, T, do]
    resid_len = np.stack([h['sequence_lengths'].astype(np.int32)
                          for h in hold])                  # [S, H]

    # ---- 1-step eval -----------------------------------------------------
    res = {'encoder_test_rmse_orig': [], 'encoder_test_rmse_all': [],
           'encoder_test_rmse_last': []}
    op, n_rows = predict_outputs(
        [{'x': fam._inputs(c.test_cf_one_step.data)} for c in colls])
    _one_step_metrics(res, colls, op, n_rows)

    # ---- n-step eval: seed-vmapped MC rollouts ---------------------------
    M = cfg.mc_samples
    flat_list, split_list, ridx_list = [], [], []
    for s, c in enumerate(colls):
        dd = c.test_cf_treatment_seq.data
        n = len(dd['prev_outputs'])
        flat = {k: np.tile(np.array(dd[k]), (M,) + (1,) * (dd[k].ndim - 1))
                for k in ('prev_outputs', 'current_treatments',
                          'static_features', 'future_past_split')}
        rng = np.random.RandomState(seeds[s])
        H = resid_bank.shape[1]
        ridx = np.stack([
            np.concatenate([rng.randint(H, size=n) for _ in range(M)])
            for _ in range(ph + 1)]).astype(np.int32)       # [ph+1, M*n]
        flat_list.append({'x': fam._inputs(flat)})
        split_list.append(flat['future_past_split'].astype(np.int32))
        ridx_list.append(ridx)

    B = max(x['x'].shape[0] for x in flat_list)
    chunk = min(eval_chunk, B)
    rollout = jax.jit(jax.vmap(fam.make_rollout_fn(net, cfg)))
    rb = jnp.asarray(resid_bank, jnp.float32)
    rl = jnp.asarray(resid_len, jnp.int32)
    if mesh is not None:
        rb, rl = _shard_seed_axis(rb, mesh), _shard_seed_axis(rl, mesh)
    outs = []
    for start in range(0, B, chunk):
        xb = np.zeros((n_seeds, chunk) + flat_list[0]['x'].shape[1:],
                      np.float32)
        sb = np.ones((n_seeds, chunk), np.int32)
        ib = np.zeros((n_seeds, ph + 1, chunk), np.int32)
        for s in range(n_seeds):
            take = max(0, min(chunk, flat_list[s]['x'].shape[0] - start))
            if take:
                xb[s, :take] = flat_list[s]['x'][start:start + take]
                sb[s, :take] = split_list[s][start:start + take]
                ib[s, :, :take] = ridx_list[s][:, start:start + take]
        put = (lambda a: jnp.asarray(a)) if mesh is None else \
            (lambda a: jax.device_put(a, _seed_sharding(mesh)))
        outs.append(rollout(params, put(xb), put(sb), put(ib), rb, rl))
    outs = np.concatenate(jax.device_get(outs), axis=2)  # [S, ph+1, B, do]
    predicted_all = outs[:, 1:].transpose(0, 2, 1, 3)    # [S, B, ph, do]
    for s, c in enumerate(colls):
        n = len(c.test_cf_treatment_seq.data['prev_outputs'])
        pred = predicted_all[s, :M * n].reshape(M, n, ph, do).mean(0)
        rmses = normalised_n_step_rmses(c.test_cf_treatment_seq, pred)
        for k, v in enumerate(np.asarray(rmses)):
            res.setdefault(f'decoder_test_rmse_{k + 2}-step',
                           []).append(float(v))
    return {k: np.asarray(v) for k, v in res.items()}
