"""chip_smoke.py and the measurement entry points on a machine without a
GPU: they fail, print no result and never fall back to the CPU.  The
helpers they share (device record, compile-cache rule) are checked here;
the phases themselves run on the card."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=os.pathsep.join(
        [REPO] + os.environ.get('PYTHONPATH', '').split(os.pathsep)))
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_require_gpus_refuses_the_cpu():
    from insite_tpu.utils import NoGPUError, require_gpus
    with pytest.raises(NoGPUError, match='no GPU'):
        require_gpus(1)


@pytest.mark.parametrize('script', [['chip_smoke.py'],
                                    ['chip_smoke.py', '--four-cards'],
                                    ['bench.py']])
def test_entry_points_fail_without_a_gpu(script):
    r = _run(script)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert 'no GPU' in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied away from the package, the script cannot pass."""
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
    r = _run(['chip_smoke.py'], cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_result_line_is_the_device_as_jax_reports_it():
    import chip_smoke
    dev = SimpleNamespace(platform='gpu', device_kind='NVIDIA H100 80GB HBM3')
    for count in (1, 4):
        line = chip_smoke.result_line([dev] * count)
        assert '\n' not in line
        assert json.loads(line) == {'ok': True, 'device': {
            'platform': 'gpu', 'kind': 'NVIDIA H100 80GB HBM3',
            'count': count}}


def test_optional_packages_reports_each():
    import chip_smoke
    found = chip_smoke.optional_packages()
    assert set(found) == {'flax', 'pandas', 'yaml'}
    assert all(isinstance(v, bool) for v in found.values())


@pytest.mark.parametrize('environ,expected', [
    ({'JAX_COMPILATION_CACHE_DIR': '/somewhere/cache'}, '/somewhere/cache'),
    ({}, os.path.join(REPO, '.jax_cache')),
    ({'JAX_COMPILATION_CACHE_DIR': ''}, os.path.join(REPO, '.jax_cache')),
])
def test_compile_cache_dir_rule(environ, expected):
    from insite_tpu import compile_cache_dir
    assert compile_cache_dir(environ) == expected


def test_compile_cache_dir_is_applied_at_import():
    import jax

    from insite_tpu import compile_cache_dir
    assert jax.config.jax_compilation_cache_dir == compile_cache_dir()


def test_check_close_reports_and_raises(capsys):
    import chip_smoke
    chip_smoke._check_close('same', [1.0, 2.0], [1.0, 2.0], rtol=1e-6)
    failures = []
    chip_smoke._check_close('off', [1.0, 2.1], [1.0, 2.0], rtol=1e-6,
                            failures=failures)
    assert failures and 'off' in failures[0]
    with pytest.raises(chip_smoke.PhaseFailed):
        chip_smoke._check_close('off', [1.0, 2.1], [1.0, 2.0], rtol=1e-6)
    out = capsys.readouterr().out
    assert 'max rel err' in out


def test_isolated_sweep_parent_never_initialises_a_backend(tmp_path):
    """`run.py --isolate`: the parent only spawns children and tables
    their rows, so each child alone holds the device."""
    code = f'''
import logging
import jax._src.xla_bridge as xb
from insite_tpu.harness import isolated, runner
from insite_tpu.harness.config import RunConfig
seen = []
real = isolated.run_isolated
def spy(*a, **k):
    seen.append(xb.backends_are_initialized())
    return real(*a, **k)
isolated.run_isolated = spy
cfg = RunConfig(methods=('sindy',), datasets=('EQ_4_D',), seed_runs=1,
                train_samples=20, val_samples=4, test_samples=4,
                isolate_runs=True, log_dir={str(tmp_path)!r},
                metrics_jsonl='')
df, _ = runner.sweep(cfg, runner.Experiment.MAIN_TABLE,
                     log=logging.getLogger('isolate-test'))
assert seen == [False], seen
assert not xb.backends_are_initialized()
assert not df.errored.astype(bool).any()
print('parent stayed off the device')
'''
    r = _run(['-c', code], cwd=tmp_path, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert 'parent stayed off the device' in r.stdout
