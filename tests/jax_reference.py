"""Shared by the port's tests that run the JAX package as their reference
(``tests/test_torch_*.py``): its persistent compilation cache, switched on
around each such test module. Not a test module of its own.

The reference's fits and transforms compile XLA programs, and
tests/conftest.py clears JAX's in-memory caches after every module, so a
program that several port modules run (the same builder at the same
shapes) used to be compiled once in each of them. Inside
:func:`_jax_compile_cache` every port module of a run reads and writes one
cache directory under the run's base temporary directory (the workers of
pytest-xdist share it), so each such program is compiled once a run. The
cache changes no result: a hit loads the executable that compiling the
same program gives. It has no size limit, so JAX takes no file lock
around its reads and writes (one lock for the whole directory serialised
the workers); an entry read while another worker writes it fails to load,
and JAX then warns and compiles the program itself. The module's end
restores the settings it found, so the JAX package's own tests run as
they always did.
"""

import os

import pytest

_SETTINGS = {"jax_compilation_cache_dir": None,
             "jax_persistent_cache_min_compile_time_secs": 0.0,
             "jax_persistent_cache_min_entry_size_bytes": 0}


@pytest.fixture(autouse=True, scope="module")
def _jax_compile_cache(tmp_path_factory):
    import jax
    from jax._src import compilation_cache
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent          # the workers' base temps share it
    cache = root / "jax_compile_cache"
    cache.mkdir(exist_ok=True)
    saved = {k: getattr(jax.config, k) for k in _SETTINGS}
    for k, v in dict(_SETTINGS, jax_compilation_cache_dir=str(cache)).items():
        jax.config.update(k, v)
    compilation_cache.reset_cache()
    yield
    for k, v in saved.items():
        jax.config.update(k, v)
    compilation_cache.reset_cache()
