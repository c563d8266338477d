"""insite_tpu — ODE discovery for longitudinal heterogeneous
treatment-effects inference (INSITE, A-SINDy, A-WSINDy and the
neural/classical baselines MSM / RMSN / CRN / G-Net / CT / EDCT) in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
benchmark harness `samholt/ODE-Discovery-for-Longitudinal-Heterogeneous-
Treatment-Effects-Inference` (see SURVEY.md for the component map).
Everything on the compute path is a pure function over arrays,
jit/vmap/shard_map-able over a `jax.sharding.Mesh`:

- `insite_tpu.core`       fixed-step sub-stepped Euler integrator, masking,
                          dtype policy (reference: libs_m/ct/src/data/pkpd/utils.py:68-94)
- `insite_tpu.sim`        the three synthetic simulators (PKPD EQ_4, cancer
                          PKPD, continuous EQ_5) as closed-form batched array
                          programs (reference: src/data/{pkpd,cancer_sim,continuous})
- `insite_tpu.data`       dataset processing pipeline: scaling, one-hot
                          treatments, active-entry masks, trajectory explosion,
                          rolling-origin splits (reference: src/data/*/dataset.py)
- `insite_tpu.discovery`  polynomial/weak-form candidate libraries, smoothed
                          finite differences, STLSQ/SR3 as batched masked ridge
                          (replaces pysindy; reference: pkpd/utils.py:96-335)
- `insite_tpu.models`     INSITE / SINDy / WSINDy estimators + neural baselines
- `insite_tpu.ops`        Pallas/Triton rollout kernels for the GPU
- `insite_tpu.eval`       normalized masked RMSE protocol + sweep aggregation
- `insite_tpu.parallel`   mesh/sharding helpers (1-D batch data parallelism)
- `insite_tpu.harness`    experiment orchestration, config, caching, logging
"""

__version__ = "0.1.0"

import os as _os


def compile_cache_dir(environ=None) -> str:
    """The persistent XLA compile cache every entry point uses:
    ``JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``
    (a fixed path, so the cache is found again; listed in .gitignore)."""
    environ = _os.environ if environ is None else environ
    return environ.get('JAX_COMPILATION_CACHE_DIR') or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        '.jax_cache')


def _use_compile_cache():
    import jax
    jax.config.update('jax_compilation_cache_dir', compile_cache_dir())


_use_compile_cache()
