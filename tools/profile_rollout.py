#!/usr/bin/env python
"""Kernel vs XLA timing of the INSITE rollout paths on the GPU.

Times, warm, in one process, in turns (kernel, XLA, XLA, kernel):

  * the INSITE Gauss-Newton fine-tune (`SINDyRegressor._fine_tune`) on the
    north-star EQ_4_D cohort, with `rollout_backend='pallas'` (the
    Pallas/Triton rollout + sensitivity kernel) and `'xla'` (jvp through
    the `lax.scan` rollout);
  * the forward rollout of that cohort: `ops.pallas_batched_rollout`
    against `models.sindy.batched_rollout`;

each call ended by `block_until_ready`, median over --reps calls, with the
first (compiling) call reported separately.  It then times both kernels at
each patient block size in --blocks (patching `ops.pallas_rollout.BLOCK_B`,
so run it last); with --trace, each path's device busy time and span per
call are read back from a jax.profiler trace of its own window (the
kernels' events are named `insite_rollout` and `insite_rollout_sens`).
Needs a GPU: there is no interpret fallback, so the times are the card's.

Usage:
    python tools/profile_rollout.py [--patients 10000] [--reps 10]
                                    [--blocks 32,64,128,256] [--trace DIR]
                                    [--out FILE.json]
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


def timed(fn, reps):
    """(first-call seconds, median warm seconds) of a blocked call."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        warm.append(time.perf_counter() - t0)
    return first, float(np.median(warm))


def in_turns(kernel_fn, xla_fn, reps):
    """kernel, XLA, XLA, kernel; returns per-path first-call and the
    median warm times of both turns."""
    k1, x1, x2, k2 = (timed(kernel_fn, reps), timed(xla_fn, reps),
                      timed(xla_fn, reps), timed(kernel_fn, reps))
    return {'kernel_first_s': k1[0], 'xla_first_s': x1[0],
            'kernel_warm_s': [k1[1], k2[1]], 'xla_warm_s': [x1[1], x2[1]]}


def _device_events(trace_dir):
    """Device events of the newest jax.profiler trace under trace_dir."""
    import glob

    import jax
    path = sorted(glob.glob(os.path.join(
        trace_dir, 'plugins', 'profile', '*', '*.xplane.pb')))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    return sorted((e for plane in data.planes
                   if plane.name.startswith('/device:GPU')
                   for line in plane.lines for e in line.events),
                  key=lambda e: e.start_ns)


def device_time(fn, reps, trace_dir):
    """(busy, span) seconds per call of `fn` on the device, from a trace
    of `reps` blocked calls: busy sums the device events (memcpys
    included), span runs from the first event's start to the last one's
    end, so span - busy is device idle inside the window."""
    import jax
    jax.block_until_ready(fn())
    with jax.profiler.trace(trace_dir):
        for _ in range(reps):
            jax.block_until_ready(fn())
    events = _device_events(trace_dir)
    busy = sum(e.duration_ns for e in events)
    span = max(e.start_ns + e.duration_ns for e in events) - \
        events[0].start_ns
    return busy * 1e-9 / reps, span * 1e-9 / reps


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--patients', type=int, default=10_000)
    p.add_argument('--reps', type=int, default=10)
    p.add_argument('--blocks', default='32,64,128,256')
    p.add_argument('--trace', default=None, metavar='DIR',
                   help='trace each path in a window of its own under DIR '
                        'and report its device busy time and span')
    p.add_argument('--out', default=None, metavar='FILE.json')
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from insite_tpu.utils import card_info, device_record, require_gpus
    devices = require_gpus(1)

    from insite_tpu.core.constants import STANDARD_DT
    from insite_tpu.data import PkpdDatasetCollection
    from insite_tpu.models.sindy import (SINDyConfig, SINDyRegressor,
                                         batched_rollout)
    from insite_tpu.ops import (pallas_batched_rollout,
                                pallas_rollout, pallas_rollout_with_sens)

    result = {'device': device_record(devices), 'card': card_info(),
              'patients': args.patients, 'reps': args.reps}

    coll = PkpdDatasetCollection(
        conf_coeff=2.0, num_patients={'train': args.patients, 'val': 4,
                                      'test': 2},
        equation_str='EQ_4_D', seed=0)
    cfg = SINDyConfig(dataset_name='EQ_4_D', sindy_threshold=0.1,
                      sindy_alpha=0.5, lam=10.0, insite=True)
    m = SINDyRegressor(cfg, coll).fit(coll.train_f)

    def fine_tune(backend):
        def run():
            m.cfg = dataclasses.replace(cfg, rollout_backend=backend)
            return m._fine_tune(coll.train_f, 1)
        return run

    result['fine_tune'] = in_turns(fine_tune('pallas'), fine_tune('xla'),
                                   args.reps)
    pk = np.asarray(fine_tune('pallas')()[0])
    px = np.asarray(fine_tune('xla')()[0])
    result['fine_tune']['max_rel_diff_preds'] = float(
        np.max(np.abs(pk - px) / np.maximum(np.abs(px), 1e-6)))

    prev, statics, arms, _ = m._rollout_args(coll.train_f)
    lib, y0 = m.library, prev[:, 0]
    coefs = jnp.asarray(m.coefs)[None]
    roll_k = jax.jit(lambda c, y, s, a: pallas_batched_rollout(
        lib, c, y, s, a, STANDARD_DT))
    roll_x = jax.jit(lambda c, y, s, a: batched_rollout(
        lib, c, y, s, a, STANDARD_DT, shared_coefs=True))
    result['rollout'] = in_turns(lambda: roll_k(coefs, y0, statics, arms),
                                 lambda: roll_x(coefs, y0, statics, arms),
                                 args.reps)

    if args.trace:
        # per-path device time, each path traced in a window of its own
        paths = {'finetune_kernel': fine_tune('pallas'),
                 'finetune_xla': fine_tune('xla'),
                 'rollout_kernel': lambda: roll_k(coefs, y0, statics, arms),
                 'rollout_xla': lambda: roll_x(coefs, y0, statics, arms)}
        result['device_busy_span_s'] = {
            name: device_time(fn, args.reps, os.path.join(args.trace, name))
            for name, fn in paths.items()}

    # both kernels at each block size: the module constant is patched and
    # the compiled kernels dropped, so each size compiles afresh
    active_idx = tuple(int(i) for i in np.flatnonzero(
        np.abs(m.coefs).reshape(-1) > 1e-3))
    coefs_b = jnp.broadcast_to(coefs, (y0.shape[0],) + coefs.shape[1:])

    def roll():
        return pallas_batched_rollout(lib, coefs, y0, statics, arms,
                                      STANDARD_DT)

    def sens():
        return pallas_rollout_with_sens(lib, coefs_b, y0, statics, arms,
                                        STANDARD_DT, active_idx)

    result['blocks'] = {}
    for block in [int(b) for b in args.blocks.split(',')]:
        pallas_rollout.BLOCK_B = block
        jax.clear_caches()
        entry = {'rollout_warm_s': timed(roll, args.reps)[1],
                 'rollout_sens_warm_s': timed(sens, args.reps)[1]}
        if args.trace:
            for name, fn in (('rollout', roll), ('rollout_sens', sens)):
                entry[f'{name}_device_busy_span_s'] = device_time(
                    fn, args.reps,
                    os.path.join(args.trace, f'{name}_block{block}'))
        result['blocks'][block] = entry

    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    print(line)


if __name__ == '__main__':
    main()
