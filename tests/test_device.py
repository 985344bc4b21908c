"""Device-facing guarantees that hold on CPU: full-precision products in the
lowered filter steps, the GPU-only entry points refusing to run elsewhere,
and the multi-device dry run refusing to fake devices."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from rfs_slam_tpu.io import sim2d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _builders():
    from tests import test_fastslam, test_rbphd_filter

    return {
        "rbphd": lambda s: test_rbphd_filter.build_filter(s, 4),
        "fastslam": lambda s: test_fastslam.build_filter(s, 4),
        "mhfastslam": lambda s: test_fastslam.build_filter(
            s, 4, max_hypotheses=3),
    }


@pytest.mark.parametrize("kind", ["rbphd", "fastslam", "mhfastslam"])
def test_step_dots_are_full_precision(kind):
    """Every f32 dot_general in the lowered step asks for HIGHEST precision
    (a default-precision f32 dot may run in TF32 on a GPU, which rounds a
    one-hot put to ~10 mantissa bits)."""
    sim = sim2d.Sim2DConfig(timesteps=10, n_landmarks=8, n_segments=2)
    filt = _builders()[kind](sim)
    state = filt.init_state(jax.random.PRNGKey(0), jnp.zeros(3))

    def step(s, odo, z, zm):
        return filt.update(filt.predict(s, odo, 0.1), z, zm)

    text = jax.jit(step).lower(state, jnp.zeros(3), jnp.zeros((24, 2)),
                               jnp.ones(24, bool)).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots, "expected one-hot products in the step"
    low = [ln.strip() for ln in dots if "f32" in ln and "HIGHEST" not in ln]
    assert not low, low[:3]


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_fail_on_cpu(script):
    """Without a GPU the chip smoke test and the bench exit non-zero and
    print no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"metric"' not in r.stdout


def test_dryrun_multichip_needs_devices():
    import __graft_entry__ as g

    with pytest.raises(RuntimeError, match="need"):
        g.dryrun_multichip(len(jax.devices()) + 1)
