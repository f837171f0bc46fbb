"""Backend-dependent choices and start-up.

The engine is plain JAX and runs on an NVIDIA GPU or on the CPU test
backend. These tests pin what differs between the two by faking
``jax.default_backend`` (the double-single coordinate default, the
spreader, the device memory budget), that the package holds no Pallas
kernel that could fall back to interpret mode, and where the package puts
JAX's persistent compilation cache.
"""

import logging
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import fftvis_tpu
from fftvis_tpu.nufft.kernels import ESKernel
from fftvis_tpu.nufft.transform import _spread_auto, _spread_scatter
from fftvis_tpu.tpu import planning

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,want", [("cpu", False), ("gpu", True)])
def test_ds_coords_default_follows_backend(monkeypatch, platform, want):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert planning.ds_coords_default() is want


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_auto_spreader_is_scatter(monkeypatch, platform):
    """FFTVIS_SPREADER=auto lowers to XLA scatter-add on both backends."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.setenv("FFTVIS_SPREADER", "auto")
    kern = ESKernel.from_eps(1e-6, sigma=2.0)
    rng = np.random.default_rng(0)
    nf = (48, 64)
    u = [jnp.asarray(rng.uniform(0, n, 200), jnp.float32) for n in nf]
    wts = jnp.asarray(rng.normal(size=(2, 200)) + 1j * rng.normal(size=(2, 200)),
                      jnp.complex64)
    fn = lambda a, b, c: _spread_auto([a, b], c, nf, kern.w, kern.beta)  # noqa: E731
    jaxpr = str(jax.make_jaxpr(fn)(u[0], u[1], wts))
    assert "scatter-add" in jaxpr and "pallas_call" not in jaxpr
    np.testing.assert_array_equal(
        np.asarray(fn(u[0], u[1], wts)),
        np.asarray(_spread_scatter(u, wts, nf, kern.w, kern.beta)),
    )


def test_package_has_no_pallas_kernel():
    """No module can select a Pallas kernel, so none can run in interpret
    mode on a GPU backend."""
    pkg = pathlib.Path(fftvis_tpu.__file__).parent
    for path in pkg.rglob("*.py"):
        src = path.read_text()
        assert "experimental.pallas" not in src, path
        assert "interpret=" not in src, path


class _Dev:
    def __init__(self, platform, stats):
        self.platform = platform
        self.device_kind = f"{platform} device"
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize(
    "platform,stats,want",
    [
        ("cpu", None, planning.HOST_MEMORY_BUDGET),
        ("gpu", {"bytes_limit": 60 * 1024**3}, 60 * 1024**3),
        ("gpu", {}, RuntimeError),
        ("gpu", None, RuntimeError),
    ],
)
def test_device_memory_limit(monkeypatch, platform, stats, want):
    """The GPU budget is the allocator's bytes_limit, never a guess."""
    monkeypatch.setattr(planning, "_MEMORY_LIMIT_CACHE", [])
    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev(platform, stats)])
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="bytes_limit"):
            planning.device_memory_limit()
    else:
        assert planning.device_memory_limit() == want


def _cache_dir_in_subprocess(extra_env):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "FFTVIS_NO_COMPILE_CACHE")}
    env.update(JAX_PLATFORMS="cpu", **extra_env)
    out = subprocess.run(
        [sys.executable, "-c",
         "import fftvis_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("preset", [False, True])
def test_compile_cache_placement(tmp_path, preset):
    """JAX_COMPILATION_CACHE_DIR wins and the package sets no directory;
    otherwise the cache is .jax_cache/ at the checkout root."""
    if preset:
        want = str(tmp_path / "jaxcache")
        assert _cache_dir_in_subprocess({"JAX_COMPILATION_CACHE_DIR": want}) == want
    else:
        want = os.path.join(REPO, ".jax_cache")
        assert fftvis_tpu.COMPILE_CACHE_DIR == want
        assert _cache_dir_in_subprocess({}) == want


def test_compile_cache_failure_is_logged(monkeypatch, caplog):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("FFTVIS_NO_COMPILE_CACHE", raising=False)

    def refuse(*a, **k):
        raise OSError("read-only file system")

    monkeypatch.setattr(jax.config, "update", refuse)
    monkeypatch.setattr(os, "makedirs", lambda *a, **k: None)
    with caplog.at_level(logging.WARNING, logger="fftvis_tpu"):
        fftvis_tpu._enable_compile_cache()
    assert "compilation cache not enabled" in caplog.text
    assert "read-only" in caplog.text


def test_chip_smoke_cpu_rehearsal():
    """chip_smoke.py end to end at toy sizes on the CPU: every phase runs,
    and the last line reports the CPU, never a GPU."""
    import json

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--rehearse"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    last = json.loads(lines[-1])
    assert last == {"ok": True, "device": {"platform": "cpu", "kind": "cpu",
                                          "count": 1}}
    for phase in ("tutorial", "type3_unpolarized", "type3_polarized",
                  "gridded_hera", "north_star"):
        (row,) = [ln for ln in lines if ln.startswith(f"[{phase}] path=")]
        err = float(row.split("max_rel_err=")[1].split()[0])
        assert np.isfinite(err) and err <= 1e-5
    assert any(ln.startswith("[gpu_tests]") for ln in lines)


def test_chip_smoke_refuses_without_a_gpu():
    """Without --rehearse and without a card the script exits non-zero and
    prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PATH="/nonexistent")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
