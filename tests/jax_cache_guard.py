"""A fixture for the port's tests that call the JAX package's
``cli.common.run_entry``.

run_entry turns on JAX's persistent compilation cache
(``lirec_tpu/cli/common.py:_enable_compilation_cache``, at
``$LIREC_TPU_CACHE`` or ``~/.cache/lirec_tpu_xla``) for the rest of the
process. Under ``pytest -n`` a test file that runs later in the same
worker process then compiles through that cache: an executable read back
from it, serialized again by the JAX package's AOT cache, fails to load
("target machine feature +prefer-no-scatter is not supported"), and
``tests/test_aot_cache.py::test_train_sweep_identical_with_aot`` fails
where it passes alone. Import ``isolated_xla_cache`` into a test module
(it is autouse, module-scoped): the cache of the module's tests lives in
a temporary directory, and the cache settings are restored when the
module ends.
"""

import os

import jax
import pytest

CACHE_SETTINGS = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs",
                  "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture(autouse=True, scope="module")
def isolated_xla_cache(tmp_path_factory):
    from jax._src import compilation_cache

    saved = {name: getattr(jax.config, name) for name in CACHE_SETTINGS}
    env = os.environ.get("LIREC_TPU_CACHE")
    os.environ["LIREC_TPU_CACHE"] = str(tmp_path_factory.mktemp("xla_cache"))
    yield
    if env is None:
        os.environ.pop("LIREC_TPU_CACHE", None)
    else:
        os.environ["LIREC_TPU_CACHE"] = env
    for name, value in saved.items():
        jax.config.update(name, value)
    compilation_cache.reset_cache()
