"""The port's MoE layer and M-RoPE against the JAX package.

MoE (``models.layers.apply_moe``): Mixtral's and Arctic's smoke variants
(4 experts, top 2; Arctic with its dense residual MLP) on the same
float32 weights and inputs, drawn with numpy. Routing (top-k experts,
capacity slots, the kept mask) must equal the reference's computation
exactly; outputs within atol 2e-4, rtol 2e-4 (``TOL``, the model tests'
tolerance); the load-balance loss within rtol 1e-6. Cases: a capacity
that binds (some (token, k) pairs overflow, asserted from numpy), one
that does not, and a router with two equal columns (ties go to the lower
expert, as ``lax.top_k`` gives them).

M-RoPE (``models.layers.apply_rope``, Qwen2-VL): three distinct position
streams against the reference within 1e-6, and, on text positions (the
three streams equal, or none given), the same bits as standard RoPE.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_params
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.models import layers as JL
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy

TOL = dict(atol=2e-4, rtol=2e-4)


def _moe_params(jcfg):
    """Layer 0's ``moe`` subtree, JAX's values and the port's tensors."""
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jparams = make_params(jcfg, seed=7)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    jmoe = jax.tree.map(lambda a: a[0], jparams["stages"][0][0]["moe"])
    return cfg, jmoe, params.layers[0].moe


def _jax_route(jmoe, xt, cfg):
    """The reference's routing lines of ``apply_moe``, in JAX."""
    N = xt.shape[0]
    E, K = cfg.num_experts, cfg.experts_per_token
    logits = jnp.einsum("nd,de->ne", jnp.asarray(xt), jmoe["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    _, gate_idx = jax.lax.top_k(probs, K)
    cap = max(1, int(cfg.capacity_factor * N * K / E))
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32).reshape(N * K, E)
    slot = ((jnp.cumsum(onehot, axis=0) - onehot) * onehot).sum(-1)
    return np.asarray(gate_idx), np.asarray(slot), cap


MOE_CASES = {
    # name: (arch, capacity_factor, tie two router columns, overflow)
    "mixtral_binds": ("mixtral-8x7b", 0.6, False, True),
    "mixtral_roomy": ("mixtral-8x7b", 2.0, False, False),
    "mixtral_ties": ("mixtral-8x7b", 1.25, True, None),
    "arctic_binds": ("arctic-480b", 0.6, False, True),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_apply_moe_matches_jax(case):
    arch, cf, tie, overflow = MOE_CASES[case]
    jcfg = jax_smoke_variant(jax_get_config(arch)).replace(
        capacity_factor=cf)
    cfg, jmoe, moe = _moe_params(jcfg)
    assert cfg.moe_dense_residual == (arch == "arctic-480b")
    if tie:  # expert 2 routes exactly like expert 1
        jmoe = dict(jmoe, router=jmoe["router"].at[:, 2].set(
            jmoe["router"][:, 1]))
        with torch.no_grad():
            moe["router"][:, 2] = moe["router"][:, 1]
    B, T = 3, 9
    x = np.random.default_rng(11).normal(
        size=(B, T, cfg.d_model)).astype(np.float32)
    jy, jaux = JL.apply_moe(jmoe, jnp.asarray(x), jcfg)
    with torch.no_grad():
        y, aux = L.apply_moe(moe, torch.from_numpy(x), cfg)
        r = L.moe_route(moe, torch.from_numpy(x.reshape(B * T, -1)), cfg)
    gate_idx, slot, cap = _jax_route(jmoe, x.reshape(B * T, -1), jcfg)
    np.testing.assert_array_equal(r.gate_idx.numpy(), gate_idx)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.keep.numpy(), slot < cap)
    assert r.cap == cap
    if overflow is not None:
        assert bool((slot >= cap).any()) == overflow
    if tie:  # some token's top two are the tied experts: 1 before 2
        both = (gate_idx == 1).any(-1) & (gate_idx == 2).any(-1)
        assert both.any()
        assert (gate_idx[both] == [1, 2]).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    if cfg.moe_dense_residual:  # the dense branch is part of y
        with torch.no_grad():
            dense = L.apply_mlp(moe["dense"], torch.from_numpy(x), cfg)
        assert float(dense.abs().max()) > 1e-2
        np.testing.assert_allclose(
            (y - dense).numpy(),
            np.asarray(jy - JL.apply_mlp(jmoe["dense"], jnp.asarray(x),
                                         jcfg)), **TOL)


def _mrope_cfgs():
    jcfg = jax_smoke_variant(jax_get_config("qwen2-vl-2b"))
    assert jcfg.rope == "mrope" and sum(jcfg.mrope_sections) == \
        jcfg.head_dim // 2
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def test_mrope_three_streams_match_jax():
    jcfg, cfg = _mrope_cfgs()
    rng = np.random.default_rng(12)
    B, T = 2, 7
    x = rng.normal(size=(B, T, 3, cfg.head_dim)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    pos3 = np.stack([pos, rng.integers(0, 40, size=(B, T)),
                     rng.integers(0, 40, size=(B, T))]).astype(np.int32)
    assert (pos3[0] != pos3[1]).any() and (pos3[1] != pos3[2]).any()
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg,
                         jnp.asarray(pos3))
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), cfg,
                       torch.from_numpy(pos3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    # the streams' sections matter: standard RoPE differs here
    std = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                       cfg.replace(rope="standard"))
    assert not torch.equal(got, std)


def test_mrope_on_text_positions_is_standard_rope_bit_for_bit():
    _, cfg = _mrope_cfgs()
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(size=(2, 5, 3, cfg.head_dim)).astype(
        np.float32)).to(torch.bfloat16)
    pos = torch.from_numpy(rng.integers(0, 3000, size=(2, 5)).astype(
        np.int32))
    std = L.apply_rope(x, pos, cfg.replace(rope="standard"))
    assert torch.equal(L.apply_rope(x, pos, cfg), std)
    assert torch.equal(L.apply_rope(x, pos, cfg, pos[None].expand(3, 2, 5)),
                       std)
