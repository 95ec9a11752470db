import os
import sys

# Tests must see exactly ONE device (the dry-run sets its own flags in a
# separate process); keep any user XLA_FLAGS but never the 512-device one.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.configs.base import ModelConfig  # noqa: E402


@pytest.fixture(scope="session")
def tiny_dense() -> ModelConfig:
    return ModelConfig(
        name="tiny-dense", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
        vocab_pad_multiple=8, dtype="float32",
    )


def make_params(cfg: ModelConfig, seed: int = 0):
    from repro.models import model as M
    from repro.models.layers import split_tree

    params, axes = split_tree(M.init_params(cfg, jax.random.key(seed)))
    return params


def hypothesis_or_stub():
    """Return ``(given, settings, st)`` — real hypothesis when installed,
    otherwise stand-ins whose ``given`` marks the decorated property-based
    tests as skipped (the rest of the module still collects and runs, so
    the tier-1 suite passes offline)."""
    try:
        from hypothesis import given, settings, strategies as st

        return given, settings, st
    except ModuleNotFoundError:
        class _AnyStrategy:
            def __getattr__(self, name):
                return lambda *a, **k: None

        def settings(*a, **k):  # noqa: ANN001 - decorator factory stub
            return lambda fn: fn

        def given(*a, **k):
            return pytest.mark.skip(reason="hypothesis not installed")

        return given, settings, _AnyStrategy()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips with a reason without one"
    )
