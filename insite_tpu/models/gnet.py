"""G-Net — LSTM g-computation with MC-sampled autoregressive rollouts.

JAX/flax re-design of the reference G-Net (src/models/gnet.py:29-267):
representation LSTM + sequential conditional heads, a holdout split whose
residuals provide the empirical noise distribution, and n-step prediction by
Monte-Carlo averaging over `mc_samples` noisy autoregressive rollouts.
"""

from __future__ import annotations

from dataclasses import dataclass

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np

from insite_tpu.models.base import CausalEstimator
from insite_tpu.models.nn.blocks import ROutcomeVitalsHead, VariationalLSTM
from insite_tpu.models.nn.training import (TrainConfig, fit_simple,
                                           masked_mean)


@dataclass
class GNetConfig:
    """config/backbone/gnet.yaml + benchmark_hparams/gnet.yaml."""

    dim_treatments: int = 1
    dim_static_features: int = 2
    dim_outcome: int = 1
    # vitals (real-EHR collections): the head predicts (outcomes, vitals)
    # sequentially-conditioned components and rollouts feed sampled vitals
    # back (reference gnet.py:64-66, 243-267)
    dim_vitals: int = 0
    fit_vitals: bool = True          # config/backbone/gnet.yaml:16
    comp_sizes: tuple = None         # default (dim_outcome[, dim_vitals])
    seq_hidden_units: int = 24
    r_size: int = 3
    fc_hidden_units: int = 48
    dropout_rate: float = 0.1
    num_layer: int = 1
    learning_rate: float = 0.01
    batch_size: int = 128
    epochs: int = 100
    mc_samples: int = 25       # config.gnet.mcsamples override (run.py:226)
    holdout_ratio: float = 0.1
    projection_horizon: int = 5
    seed: int = 0


def _comp_sizes(cfg: GNetConfig):
    if cfg.comp_sizes is not None:
        assert sum(cfg.comp_sizes) == cfg.dim_outcome + cfg.dim_vitals
        return tuple(cfg.comp_sizes)
    return ((cfg.dim_outcome, cfg.dim_vitals) if cfg.dim_vitals > 0
            else (cfg.dim_outcome,))


class GNetNetwork(nn.Module):
    cfg: GNetConfig

    @nn.compact
    def __call__(self, x, train=False):
        cfg = self.cfg
        h = VariationalLSTM(cfg.seq_hidden_units, cfg.num_layer,
                            cfg.dropout_rate, name='repr_net')(x, None,
                                                               train)
        return ROutcomeVitalsHead(cfg.r_size, cfg.fc_hidden_units,
                                  _comp_sizes(cfg),
                                  name='r_outcome_vitals_head')(h)


def _inputs(data):
    """(treatments, [vitals,] prev_outputs, statics) feature layout
    (reference gnet.py:141-148)."""
    T = data['prev_outputs'].shape[1]
    statics = np.repeat(np.asarray(data['static_features'])[:, None, :], T,
                        axis=1)
    parts = [data['current_treatments']]
    if 'vitals' in data:
        parts.append(data['vitals'])
    parts += [data['prev_outputs'], statics]
    return np.concatenate(parts, axis=-1)


def make_rollout_fn(net, cfg: GNetConfig):
    """On-device MC rollout over one padded chunk as a PURE function
    ``rollout(params, x, split, ridx, resid_bank, resid_len) ->
    [ph+1, rows, dim_outcome]``: scan over the horizon, each step one
    forward pass + noisy write-back into the prev_outputs feature slice.
    Emits the CLEAN per-step outcome outputs (reference records predictions
    before residual injection, gnet.py:247-259).  With vitals, sampled
    next-vitals are fed back into the vitals feature slice alongside the
    outcome write-back (gnet.py:258-262).  Pure, so ``jax.vmap`` trains a
    whole seed column of rollouts in one dispatch."""
    dv = cfg.dim_vitals
    vo = cfg.dim_treatments            # vitals feature offset
    po = cfg.dim_treatments + dv       # prev_outputs feature offset
    do = cfg.dim_outcome

    def rollout(params, x, split, ridx, resid_bank, resid_len):
        rows = jnp.arange(x.shape[0])
        T = x.shape[1]

        def step(carry_x, scanned):
            t, ridx_t = scanned
            pred = net.apply({'params': params}, carry_x,
                             False)[..., :do + dv]
            idx = split - 1 + t
            out_t = pred[rows, idx]                       # [c, do+dv]
            rl = resid_len[ridx_t]
            resid = resid_bank[ridx_t, jnp.minimum(idx, rl - 1)]
            noisy = out_t + resid
            wt = jnp.minimum(split + t, T - 1)
            write = t < cfg.projection_horizon
            cur_o = carry_x[rows, wt, po:po + do]
            new_o = jnp.where(write, noisy[:, :do], cur_o)
            carry_x = carry_x.at[rows, wt, po:po + do].set(new_o)
            if dv > 0:
                cur_v = carry_x[rows, wt, vo:vo + dv]
                new_v = jnp.where(write, noisy[:, do:], cur_v)
                carry_x = carry_x.at[rows, wt, vo:vo + dv].set(new_v)
            return carry_x, out_t[:, :do]

        ph1 = cfg.projection_horizon + 1
        _, outs = jax.lax.scan(step, x, (jnp.arange(ph1), ridx))
        return outs                                       # [ph+1, c, do]

    return rollout


class GNet(CausalEstimator):
    model_type = 'g_net'
    tuning_criterion = 'rmse'

    def __init__(self, cfg: GNetConfig, dataset_collection):
        self.cfg = cfg
        self.collection = dataset_collection
        self.net = GNetNetwork(cfg)
        self.params = None
        if not dataset_collection.processed_data_multi:
            dataset_collection.process_data_multi()
        dataset_collection.split_train_f_holdout(cfg.holdout_ratio)
        dataset_collection.explode_cf_treatment_seq(cfg.mc_samples)

    def fit(self, train_f=None, val_f=None):
        cfg = self.cfg
        data = self.collection.train_f.data
        x = _inputs(data)
        rng = jax.random.PRNGKey(cfg.seed)
        rng, init_rng = jax.random.split(rng)
        params = self.net.init({'params': init_rng, 'dropout': rng},
                               jnp.asarray(x[:2], jnp.float32),
                               False)['params']
        has_vitals = cfg.dim_vitals > 0 and 'next_vitals' in data
        batch_data = {'x': jnp.asarray(x, jnp.float32),
                      'outputs': jnp.asarray(data['outputs'], jnp.float32),
                      'active_entries': jnp.asarray(data['active_entries'],
                                                    jnp.float32)}
        if has_vitals:
            batch_data['next_vitals'] = jnp.asarray(data['next_vitals'],
                                                    jnp.float32)

        def loss_fn(p, batch, rngs):
            pred = self.net.apply({'params': p}, batch['x'], True,
                                  rngs=rngs)
            mse = (pred[..., :cfg.dim_outcome] - batch['outputs']) ** 2
            loss = masked_mean(mse, batch['active_entries'])
            if has_vitals and cfg.fit_vitals:
                # next_vitals is one step shorter (gnet.py:157-168)
                vp = pred[:, :-1, cfg.dim_outcome:cfg.dim_outcome +
                          cfg.dim_vitals]
                vmse = (vp - batch['next_vitals']) ** 2
                loss = loss + masked_mean(vmse,
                                          batch['active_entries'][:, 1:])
            return loss

        tc = TrainConfig(cfg.epochs, cfg.batch_size, cfg.learning_rate)
        self.params = fit_simple(loss_fn, params, batch_data, tc, rng)

        # holdout residual distribution (gnet.py:180-202); with
        # holdout_ratio <= 0 no split exists and rollouts run noise-free.
        # With vitals the bank covers (outcomes, next_vitals) jointly, one
        # step shorter (gnet.py:185-199)
        holdout = getattr(self.collection, 'train_f_holdout', None)
        if holdout is not None and len(holdout.data['outputs']):
            preds = self._predict_data(holdout.data,
                                       vitals=has_vitals)
            if has_vitals:
                target = np.concatenate(
                    [np.asarray(holdout.data['outputs'])[:, :-1],
                     np.asarray(holdout.data['next_vitals'])], axis=-1)
                self.holdout_resid = target - preds[:, :-1]
                self.holdout_resid_len = \
                    holdout.data['sequence_lengths'].astype(int) - 1
            else:
                self.holdout_resid = \
                    np.asarray(holdout.data['outputs']) - preds
                self.holdout_resid_len = \
                    holdout.data['sequence_lengths'].astype(int)
        else:
            self.holdout_resid = self.holdout_resid_len = None
        return self

    # Cap rows per dispatch: the stacked MC eval batch (mc_samples x
    # exploded cf rows ~ 270k sequences) otherwise compiles a program
    # larger than 16 GiB of device memory.  The last chunk is zero-padded to the chunk
    # size so every dispatch shares one compiled shape.
    _PREDICT_CHUNK = 65536

    def _predict_data(self, data, vitals=False):
        out_dim = self.cfg.dim_outcome + \
            (self.cfg.dim_vitals if vitals else 0)
        x = np.asarray(_inputs(data), np.float32)
        B, chunk = x.shape[0], self._PREDICT_CHUNK
        if B <= chunk:
            pred = self.net.apply({'params': self.params}, jnp.asarray(x),
                                  False)
            return np.array(pred[..., :out_dim])
        # keep per-chunk outputs on device, fetch once at the end (one
        # batched transfer instead of a blocking pull per chunk; the
        # sliced outputs are small, ~[B, T, dim_outcome])
        outs = []
        for s in range(0, B, chunk):
            xb = x[s:s + chunk]
            pad = chunk - xb.shape[0]
            if pad:
                xb = np.concatenate(
                    [xb, np.zeros((pad,) + xb.shape[1:], xb.dtype)])
            pred = self.net.apply({'params': self.params}, jnp.asarray(xb),
                                  False)
            outs.append(pred[:chunk - pad, ..., :out_dim])
        return np.concatenate(jax.device_get(outs))

    def get_predictions(self, dataset) -> np.ndarray:
        return self._predict_data(dataset.data)

    def _rollout_fn(self):
        self._rollout_jit = jax.jit(make_rollout_fn(self.net, self.cfg))
        return self._rollout_jit

    def get_autoregressive_predictions(self, datasets) -> np.ndarray:
        """MC rollouts with residual-noise injection (gnet.py:230-267).

        The M dataset copies are stacked into one [M*n] batch and the whole
        (horizon+1)-step rollout runs ON DEVICE in row chunks: one input
        push and one output fetch per chunk instead of per step (the
        host-loop version moved ~2.7 GB between host and device per
        eval). Residual draws keep the reference's per-(t, m) np.random
        order."""
        cfg = self.cfg
        ph = cfg.projection_horizon
        assert isinstance(datasets, list) and len(datasets) == cfg.mc_samples
        rng = np.random.RandomState(cfg.seed)
        M = cfg.mc_samples
        n = len(datasets[0].data['prev_outputs'])
        keys = ['prev_outputs', 'current_treatments', 'static_features',
                'future_past_split']
        if 'vitals' in datasets[0].data:
            keys.append('vitals')
        flat = {k: np.concatenate([np.array(d.data[k]) for d in datasets])
                for k in keys}
        x = np.asarray(_inputs(flat), np.float32)
        split = flat['future_past_split'].astype(np.int32)
        B = M * n

        if self.holdout_resid is not None:
            ridx = np.stack([
                np.concatenate([rng.randint(len(self.holdout_resid), size=n)
                                for _ in range(M)])
                for _ in range(ph + 1)]).astype(np.int32)     # [ph+1, B]
            resid_bank = jnp.asarray(self.holdout_resid, jnp.float32)
            resid_len = jnp.asarray(self.holdout_resid_len, jnp.int32)
        else:
            ridx = np.zeros((ph + 1, B), np.int32)
            resid_bank = jnp.zeros((1,) + x.shape[1:2] +
                                   (cfg.dim_outcome + cfg.dim_vitals,),
                                   jnp.float32)
            resid_len = jnp.ones((1,), jnp.int32)

        rollout = getattr(self, '_rollout_jit', None) or self._rollout_fn()
        chunk = min(self._PREDICT_CHUNK, B)
        outs = []
        for s in range(0, B, chunk):
            xb, sb, rb = x[s:s + chunk], split[s:s + chunk], \
                ridx[:, s:s + chunk]
            pad = chunk - xb.shape[0]
            if pad:
                xb = np.concatenate(
                    [xb, np.zeros((pad,) + xb.shape[1:], xb.dtype)])
                sb = np.concatenate([sb, np.ones(pad, sb.dtype)])
                rb = np.concatenate(
                    [rb, np.zeros((ph + 1, pad), rb.dtype)], axis=1)
            out = rollout(self.params, jnp.asarray(xb), jnp.asarray(sb),
                          jnp.asarray(rb), resid_bank, resid_len)
            outs.append(out[1:, :chunk - pad])
        predicted = np.concatenate(jax.device_get(outs), axis=1)
        return predicted.transpose(1, 0, 2).reshape(
            M, n, ph, cfg.dim_outcome).mean(0)

    def get_normalised_n_step_rmses(self, dataset, datasets_mc=None):
        datasets_mc = datasets_mc or self.collection.test_cf_treatment_seq_mc
        return super().get_normalised_n_step_rmses(dataset, datasets_mc)
