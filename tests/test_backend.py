"""utils/backend.py: the platform query and the compile-cache rule."""

from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_platform_is_the_default_device():
    import jax

    from genomicbreedingmodels_tpu.utils.backend import platform

    assert platform() == jax.devices()[0].platform == "cpu"


def test_compile_cache_honours_env_and_sets_nothing(monkeypatch):
    import jax

    from genomicbreedingmodels_tpu.utils import backend

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert backend.compile_cache_dir() == "/some/cache"
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    assert backend.enable_compile_cache() == "/some/cache"
    assert "jax_compilation_cache_dir" not in [k for k, _ in calls]


def test_compile_cache_default_is_fixed_inside_checkout(monkeypatch):
    import jax

    from genomicbreedingmodels_tpu.utils import backend

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = Path(backend.compile_cache_dir())
    assert path == REPO / ".jax_cache"
    assert backend.compile_cache_dir() == str(path)  # same on every call
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    backend.enable_compile_cache()
    assert ("jax_compilation_cache_dir", str(path)) in calls
