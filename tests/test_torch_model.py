"""The port's dense model against the JAX package on the same weights.

JAX ``init_params`` weights cross through numpy (``params_from_numpy``);
prefill over left-padded prompts and one cached 5-token verify block go
through both. Last-position logits and every layer's (k, v, cache_pos)
must agree within atol 2e-4, rtol 2e-4 (float32; the summation order
differs between XLA and PyTorch); cache_pos must be exact. The cached
block runs the port's spec-verify plain version against JAX's XLA path.
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
from repro.models import model as JM
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy

TOL = dict(atol=2e-4, rtol=2e-4)


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def port_params(jparams, cfg):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _jax_layer_caches(jcache, cfg):
    """Per-layer (k, v, cpos) numpy triples from the JAX scan-staged cache."""
    out = []
    for si, (unit, repeats) in enumerate(cfg.scan_stages):
        for r in range(repeats):
            for ui in range(len(unit)):
                trip = jcache.stages[si][ui]
                out.append(tuple(np.asarray(a[r] if repeats > 1 else a)
                                 for a in trip))
    return out


def _compare_caches(jcache, tcache, cfg):
    jl = _jax_layer_caches(jcache, cfg)
    assert len(jl) == len(tcache.layers) == cfg.num_layers
    for (jk, jv, jp), (tk, tv, tp) in zip(jl, tcache.layers):
        np.testing.assert_array_equal(jp, tp.numpy())
        S = jk.shape[1] - 1  # the trash slot's contents are unspecified
        np.testing.assert_allclose(tk.numpy()[:, :S], jk[:, :S], **TOL)
        np.testing.assert_allclose(tv.numpy()[:, :S], jv[:, :S], **TOL)
    np.testing.assert_array_equal(np.asarray(jcache.lengths),
                                  tcache.lengths.numpy())


def _configs(tiny_dense):
    return {
        "tiny_dense": tiny_dense,
        "qwen3_8b_smoke": jax_smoke_variant(jax_get_config("qwen3-8b")),
        "qwen2_1_5b_smoke": jax_smoke_variant(jax_get_config("qwen2-1.5b")),
    }


@pytest.mark.parametrize("name", ["tiny_dense", "qwen3_8b_smoke",
                                  "qwen2_1_5b_smoke"])
def test_prefill_and_cached_block_match_jax(tiny_dense, name):
    jcfg = _configs(tiny_dense)[name]
    assert jcfg.dtype == "float32"
    cfg = port_cfg(jcfg)
    jparams = make_params(jcfg, seed=3)
    params = port_params(jparams, cfg)
    rng = np.random.default_rng(4)
    B, Tp, max_len = 3, 12, 64
    lens = [12, 7, 3]
    toks = np.zeros((B, Tp), np.int32)
    mask = np.zeros((B, Tp), bool)
    for b, n in enumerate(lens):
        toks[b, Tp - n:] = rng.integers(0, jcfg.vocab_size, size=n)
        mask[b, Tp - n:] = True
    jlast, jcache = JM.prefill(jparams, jcfg, jnp.asarray(toks),
                               jnp.asarray(mask), max_len=max_len)
    tlast, tcache = TM.prefill(params, cfg, torch.from_numpy(toks),
                               torch.from_numpy(mask), max_len=max_len)
    assert tlast.dtype == torch.float32
    assert tlast.shape == (B, jcfg.padded_vocab)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    _compare_caches(jcache, tcache, jcfg)

    # one cached 5-token verify block; row 2 is inactive (trash-slot path)
    block = rng.integers(0, jcfg.vocab_size, size=(B, 5)).astype(np.int32)
    valid = np.ones((B, 5), bool)
    valid[2] = False
    jlog, jcache2, _ = JM.forward(
        jparams, jcfg, jnp.asarray(block), cache=jcache,
        valid=jnp.asarray(valid), commit_upto=jnp.zeros((B,), jnp.int32),
    )
    tlog, tcache2 = TM.forward(params, cfg, torch.from_numpy(block),
                               cache=tcache, valid=torch.from_numpy(valid))
    assert tlog.shape == (B, 5, jcfg.padded_vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _compare_caches(jcache2, tcache2, jcfg)


def test_init_params_shapes_and_scale():
    jcfg = jax_smoke_variant(jax_get_config("qwen3-8b"))
    cfg = port_cfg(jcfg)
    params = TM.init_params(cfg, seed=1, device="cpu")
    ref = jax.tree.map(np.asarray, make_params(jcfg))
    assert tuple(params.embed.shape) == ref["embed"].shape
    assert tuple(params.lm_head.shape) == ref["lm_head"].shape
    blk = params.layers[0]
    jblk = ref["stages"][0][0]
    for group in ("norm", "attn", "mlp_norm", "mlp"):
        for k, v in getattr(blk, group).items():
            assert tuple(v.shape) == jblk[group][k].shape[1:], (group, k)
            assert v.dtype == torch.float32
    # N(0,1)/sqrt(fan_in): the std of wq is 1/sqrt(d_model), like JAX's
    std = float(blk.attn["wq"].std())
    assert abs(std - 1 / np.sqrt(cfg.d_model)) < 0.1 / np.sqrt(cfg.d_model)
    assert TM.param_count(params) == sum(a.size for a in jax.tree.leaves(ref))


def test_bfloat16_leaves_cross_bit_exactly():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 17), jnp.bfloat16))
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_long_prefill_is_refused():
    jcfg = jax_smoke_variant(jax_get_config("qwen3-8b"))
    cfg = port_cfg(jcfg).replace(num_layers=1, vocab_size=64,
                                 vocab_pad_multiple=64, d_model=64,
                                 num_heads=2, num_kv_heads=1, head_dim=32,
                                 d_ff=64)
    params = TM.init_params(cfg, seed=0, device="cpu")
    toks = torch.zeros((1, 2048), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="_flash_attn_train"):
        TM.prefill(params, cfg, toks, torch.ones_like(toks, dtype=torch.bool),
                   max_len=2048)


def test_no_card_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg = jax_smoke_variant(jax_get_config("qwen3-8b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_params(port_cfg(jcfg), seed=0)
