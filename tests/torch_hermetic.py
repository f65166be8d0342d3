"""An autouse fixture for the port's tests that drive its entry points.

The CLIs and ``fold_pipeline`` consult the tuning cache by default
(``~/.cache/pypulsar_tpu_torch/tune.json``). A test module that imports
:func:`hermetic_tune_cache` points that default at a throwaway file, so
a winner stored on the machine never moves a count, a chunk or a byte
the test holds. A test that needs a given cache passes its own path.
"""

import pytest

from pypulsar_tpu_torch.tune import cache


@pytest.fixture(autouse=True)
def hermetic_tune_cache(tmp_path_factory, monkeypatch):
    path = str(tmp_path_factory.mktemp("tune") / "tune.json")
    monkeypatch.setattr(cache, "default_cache_path", lambda: path)
    return path
