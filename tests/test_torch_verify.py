"""Lossless verification: the port's ``verify_block`` / ``sample_token``
against the JAX package's. Greedy must be exact. At T > 0 the port is fed
JAX's own draws — ``jax.random.uniform(key, (B, K))`` for acceptance and
the Gumbel noise of ``fold_in(key, 1)`` for the residual sample — so the
accepted counts and the tokens must be equal too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import verify as JV
from repro_torch.core import verify as TV


def _case(seed, B=6, K=5, V=40):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, K + 1, V)).astype(np.float32) * 3.0
    block = rng.integers(0, V, size=(B, K + 1)).astype(np.int32)
    # make most drafts the argmax so acceptance runs are non-trivial
    preds = logits.argmax(-1)
    for b in range(B):
        n_good = int(rng.integers(0, K + 1))
        block[b, 1:1 + n_good] = preds[b, :n_good]
    budgets = rng.integers(0, K + 1, size=B).astype(np.int32)
    budgets[0] = K
    active = np.ones(B, bool)
    active[-1] = False
    return logits, block, budgets, active


def _cmp(jres, tres):
    for name, j, t in zip(JV.VerifyResult._fields, jres, tres):
        assert t.dtype == torch.int32, name
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_verify_block_exact(seed):
    logits, block, budgets, active = _case(seed)
    jres = JV.verify_block(jnp.asarray(logits), jnp.asarray(block),
                           jnp.asarray(budgets), active=jnp.asarray(active))
    tres = TV.verify_block(torch.from_numpy(logits), torch.from_numpy(block),
                           torch.from_numpy(budgets),
                           active=torch.from_numpy(active))
    _cmp(jres, tres)
    assert int(tres.accepted.max()) > 0


@pytest.mark.parametrize("seed,temperature", [(0, 0.7), (1, 1.0), (2, 1.3)])
def test_stochastic_verify_block_with_jax_draws(seed, temperature):
    logits, block, budgets, active = _case(seed)
    B, K1, V = logits.shape
    key = jax.random.key(100 + seed)
    u = np.array(jax.random.uniform(key, (B, K1 - 1)))
    g = np.array(jax.random.gumbel(jax.random.fold_in(key, 1), (B, V)))
    jres = JV.verify_block(jnp.asarray(logits), jnp.asarray(block),
                           jnp.asarray(budgets), temperature=temperature,
                           key=key, active=jnp.asarray(active))
    tres = TV.verify_block(torch.from_numpy(logits), torch.from_numpy(block),
                           torch.from_numpy(budgets), temperature=temperature,
                           active=torch.from_numpy(active),
                           uniforms=torch.from_numpy(u),
                           gumbel=torch.from_numpy(g))
    _cmp(jres, tres)


def test_stochastic_verify_draws_from_generator_when_absent():
    logits, block, budgets, active = _case(3)
    args = (torch.from_numpy(logits), torch.from_numpy(block),
            torch.from_numpy(budgets))
    r1 = TV.verify_block(*args, temperature=1.0,
                         generator=torch.Generator().manual_seed(5))
    r2 = TV.verify_block(*args, temperature=1.0,
                         generator=torch.Generator().manual_seed(5))
    for a, b in zip(r1, r2):
        assert torch.equal(a, b)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_sample_token_matches_jax(temperature):
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(5, 50)).astype(np.float32)
    key = jax.random.key(7)
    want = np.asarray(JV.sample_token(jnp.asarray(logits),
                                      temperature=temperature, key=key))
    g = torch.from_numpy(np.array(jax.random.gumbel(key, (5, 50))))
    got = TV.sample_token(torch.from_numpy(logits), temperature=temperature,
                          gumbel=g)
    np.testing.assert_array_equal(want, got.numpy())
