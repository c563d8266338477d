"""First-class tracing/profiling utilities.

The reference left profiling as breadcrumbs — a commented-out
`jax.profiler.trace` (pkpd_simulation.py:1143) and ad-hoc
`time.perf_counter` logging (run.py:94,128-129; sindy.py:202-216).  Here
they are proper tools: a profiler-trace context manager (view the dump with
TensorBoard or Perfetto), a dispatch-safe wall-clock timer that blocks on
device results, and a stage logger matching the reference's
`seconds_taken` conventions.
"""

from __future__ import annotations

import contextlib
import logging
import time

import jax

logger = logging.getLogger('insite_tpu')


@contextlib.contextmanager
def trace(log_dir: str = '/tmp/insite_tpu_trace',
          create_perfetto_link: bool = False):
    """jax.profiler trace around a code block:

        with profiling.trace('/tmp/tb'):
            model.fit(train_f)

    Open the dump with TensorBoard's profile plugin, or pass
    ``create_perfetto_link=True`` for a one-shot Perfetto URL.
    """
    with jax.profiler.trace(log_dir,
                            create_perfetto_link=create_perfetto_link):
        yield
    logger.info(f'[trace] profile written to {log_dir}')


def time_blocked(fn, *args, reps: int = 1, warmup: int = 1, **kwargs):
    """Wall-clock a jitted callable correctly: block on the result tree so
    async dispatch doesn't lie, and separate compile (warmup) from steady
    state.  Returns (seconds_per_call, last_result)."""
    result = None
    for _ in range(warmup):
        result = jax.block_until_ready(fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(reps):
        result = jax.block_until_ready(fn(*args, **kwargs))
    return (time.perf_counter() - t0) / max(reps, 1), result


@contextlib.contextmanager
def wall_clock_logger(stage: str, log=None):
    """Log '<stage>: Xs' on exit (the reference's seconds_taken idiom),
    flushing outstanding device work first."""
    t0 = time.perf_counter()
    yield
    jax.effects_barrier()
    (log or logger).info(f'[{stage}] {time.perf_counter() - t0:.2f}s')


class NoGPUError(RuntimeError):
    """A measurement or smoke path found no GPU; it does not fall back to
    the CPU."""


def require_gpus(count: int = 1):
    """The first `count` JAX devices, which must be GPUs."""
    devices = jax.devices()
    if devices[0].platform != 'gpu':
        raise NoGPUError(f'no GPU: JAX found {devices}')
    if len(devices) < count:
        raise NoGPUError(f'need {count} GPUs, JAX found {len(devices)}')
    return devices[:count]


def device_record(devices) -> dict:
    """The device as JAX reports it, for every printed result."""
    return {'platform': devices[0].platform,
            'kind': devices[0].device_kind, 'count': len(devices)}


def card_info() -> str:
    """'<name>, <power limit>' of the first card, from nvidia-smi in a
    child process that stays off JAX (a card below its top power limit
    runs slower under load, so every kept number carries it)."""
    import subprocess
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()
