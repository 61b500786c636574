"""The port's build audit: the build directory and per-library counts.

``fantoch_tpu_torch/core/compile_cache.py`` is the port's counterpart of
the JAX package's compile-cache module:

* the build directory resolves with the precedence of the reference's
  ``resolve_cache_dir`` (``tests/test_compile_cache.py::
  test_resolve_cache_dir_precedence``): ``Config.compile_cache_dir`` >
  ``FANTOCH_COMPILE_CACHE_DIR`` > the obs dir's default > None (the
  package's ``build/``).  The obs dir's default is ``<obs>/build`` where
  the reference's is ``<obs>/.jax_cache``; every other answer is equal;
* ``ensure_compile_cache`` points the loaders at that directory, and the
  audit counts each library's compiler runs and ``dlopen`` calls: the
  native Tarjan library (``native/tarjan.cpp``, built by g++ here)
  stands in for a ``csrc`` source, which needs nvcc.  A first load builds
  it once and loads it once, a cached one counts nothing, a fresh
  process image (``_lib`` dropped) loads the hashed library again without
  a build; the device counters read the same numbers;
* every ``csrc/*.cu`` source has its entry from import on, and a build
  that cannot find nvcc counts no build.

One collected item on purpose (ROADMAP.md Queue C).
"""

import os

import pytest

from fantoch_tpu.core import compile_cache as ref_cache
from fantoch_tpu_torch import native
from fantoch_tpu_torch.core import Config
from fantoch_tpu_torch.core import compile_cache
from fantoch_tpu_torch.observability import device
from fantoch_tpu_torch.ops import _build


def precedence(monkeypatch, tmp_path):
    from fantoch_tpu.core.config import Config as RefConfig

    obs = str(tmp_path)
    answers = {}
    for name, cache, config_cls in (("jax", ref_cache, RefConfig),
                                    ("port", compile_cache, Config)):
        monkeypatch.delenv("FANTOCH_COMPILE_CACHE_DIR", raising=False)
        got = [cache.resolve_cache_dir(None), cache.resolve_cache_dir(None, obs_dir=obs)]
        monkeypatch.setenv("FANTOCH_COMPILE_CACHE_DIR", "/env/dir")
        got.append(cache.resolve_cache_dir(None, obs_dir=obs))
        cfg = config_cls(3, 1, compile_cache_dir="/cfg/dir")
        got.append(cache.resolve_cache_dir(cfg, obs_dir=obs))
        got.append(cache.resolve_cache_dir(config_cls(3, 1), obs_dir=obs))
        answers[name] = got
    monkeypatch.delenv("FANTOCH_COMPILE_CACHE_DIR")
    assert answers["port"] == [
        None, os.path.join(obs, "build"), "/env/dir", "/cfg/dir", "/env/dir"]
    assert answers["jax"][1] == os.path.join(obs, ".jax_cache")
    assert [a for i, a in enumerate(answers["jax"]) if i != 1] == [
        a for i, a in enumerate(answers["port"]) if i != 1]
    # ensure_compile_cache: the default, then an explicit directory
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    assert compile_cache.ensure_compile_cache() == str(compile_cache.DEFAULT_BUILD_DIR)
    assert _build.BUILD_DIR == compile_cache.DEFAULT_BUILD_DIR
    chosen = str(tmp_path / "libs")
    assert compile_cache.ensure_compile_cache(Config(3, 1, compile_cache_dir=chosen)) == chosen
    assert str(_build.BUILD_DIR) == chosen and str(native.BUILD_DIR) == chosen
    assert _build.library_path("graph_plane_step").parent == _build.BUILD_DIR
    assert native.library_path().parent == native.BUILD_DIR
    return chosen


def counts(monkeypatch, build_dir):
    sources = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    assert sources == ["graph_general", "graph_plane_step", "pred_plane", "table_plane"]
    assert set(sources) | {native.LIBRARY} <= set(compile_cache.library_counts())
    monkeypatch.setattr(compile_cache, "_libraries", {
        name: dict(entry) for name, entry in compile_cache._libraries.items()})
    compile_cache.clear_library_counts()
    monkeypatch.setattr(native, "_lib", None)
    before = (device.recompile_count(), device.cache_hit_count(),
              device.cache_miss_count())
    assert before == (0, 0, 0)
    assert not native.library_path().exists()
    native.load()
    assert native.library_path().parent == native.BUILD_DIR == type(native.BUILD_DIR)(build_dir)
    assert native.library_path().exists()
    assert compile_cache.library_counts()[native.LIBRARY] == {"builds": 1, "loads": 1}
    native.load()  # cached: nothing counted
    assert compile_cache.library_counts()[native.LIBRARY] == {"builds": 1, "loads": 1}
    assert (device.recompile_count(), device.cache_hit_count(),
            device.cache_miss_count()) == (1, 0, 1)
    assert compile_cache.build_ms() > 0
    # a fresh process image: the hashed library loads, no compiler runs
    monkeypatch.setattr(native, "_lib", None)
    native.load()
    assert compile_cache.library_counts()[native.LIBRARY] == {"builds": 1, "loads": 2}
    assert (device.recompile_count(), device.cache_hit_count(),
            device.cache_miss_count()) == (1, 1, 1)
    counters = device.device_counters()
    assert (counters["extension_builds"], counters["extension_loads"]) == (1, 2)
    # a csrc source with no nvcc at hand: refused, no build counted
    monkeypatch.setattr(_build, "_nvcc", lambda: "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("table_plane")
    assert compile_cache.library_counts()["table_plane"] == {"builds": 0, "loads": 0}
    # the resolver still answers through the library it loaded
    import numpy as np

    order, sizes = native.resolve_sccs(
        np.array([0, 1, 2], np.int32), np.array([1, 0], np.int32),
        np.array([5, 3], np.int64))
    assert sorted(order.tolist()) == [0, 1] and sizes.tolist() == [2, 2]


def test_build_audit(monkeypatch, tmp_path):
    build_dir = precedence(monkeypatch, tmp_path)
    counts(monkeypatch, build_dir)
