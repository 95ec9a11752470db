"""The port's model against the JAX package on the same weights: dense
decoders (Qwen3, Qwen2, Yi, ChatGLM3's partial RoPE with QKV bias,
Command R+'s parallel blocks with LayerNorm and tied embeddings), the
Qwen2-VL backbone's M-RoPE, the MoE decoders (Mixtral's sliding window,
Arctic's dense residual), the hybrid RG-LRU + local-attention stack
(RecurrentGemma's smoke variant, and an 8-layer cut of it whose layers
form a scanned stage of two units plus two remainder stages), xLSTM's
smoke variant (mLSTM + sLSTM, no MLP; and a 5-layer cut: two units
scanned, one remainder layer) and the encoder-decoder's decoder run
without an encoder output (its cross-attention skipped, as in the
reference; ``tests/test_torch_encdec.py`` runs it with one).

JAX ``init_params`` weights cross through numpy (``params_from_numpy``);
prefill over left-padded prompts and one cached 5-token verify block go
through both. Last-position logits and every layer's cache must agree
within atol 2e-4, rtol 2e-4 for the dense and xLSTM configs (float32;
the summation order differs between XLA and PyTorch) and within 1e-5
for the hybrid ones; cache_pos must be exact. The cached block runs the port's
spec-verify and RG-LRU plain versions against JAX's XLA path; for a
hybrid model it collects staged recurrent states, which
``commit_staged_cache`` gathers at per-row acceptance counts (0 for the
inactive row).
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
TOL_HYBRID = dict(atol=1e-5, rtol=1e-5)


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def port_params(jparams, cfg):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")


XLSTM_KEYS = {"mlstm": ("C", "n", "m"), "slstm": ("c", "n", "h", "m")}


def _jax_layer_caches(jcache, cfg):
    """Per-layer numpy entries from the JAX scan-staged cache: (k, v,
    cpos) triples for attention, {"h", "conv"} dicts for RG-LRU, and the
    xLSTM tuples as the port's dicts."""
    out = []
    for si, (unit, repeats) in enumerate(cfg.scan_stages):
        for r in range(repeats):
            for ui, kind in enumerate(unit):
                entry = jax.tree.map(
                    lambda a: np.asarray(a[r] if repeats > 1 else a),
                    jcache.stages[si][ui])
                if kind in XLSTM_KEYS:
                    entry = dict(zip(XLSTM_KEYS[kind], entry))
                out.append(entry)
    return out


def _compare_caches(jcache, tcache, cfg, tol=TOL):
    jl = _jax_layer_caches(jcache, cfg)
    assert len(jl) == len(tcache.layers) == cfg.num_layers
    for jentry, tentry in zip(jl, tcache.layers):
        if isinstance(jentry, dict):
            assert sorted(tentry) == sorted(jentry)
            for key, want in jentry.items():
                np.testing.assert_allclose(tentry[key].numpy(), want, **tol)
            continue
        (jk, jv, jp), (tk, tv, tp) = jentry, tentry
        np.testing.assert_array_equal(jp, tp.numpy())
        S = jk.shape[1] - 1  # the trash slot's contents are unspecified
        np.testing.assert_allclose(tk.numpy()[:, :S], jk[:, :S], **tol)
        np.testing.assert_allclose(tv.numpy()[:, :S], jv[:, :S], **tol)
    np.testing.assert_array_equal(np.asarray(jcache.lengths),
                                  tcache.lengths.numpy())


def _configs(tiny_dense):
    hybrid = jax_smoke_variant(jax_get_config("recurrentgemma-9b"))
    xlstm = jax_smoke_variant(jax_get_config("xlstm-125m"))
    return {
        "xlstm_125m_smoke": xlstm,
        "xlstm_125m_smoke_5_layers": xlstm.replace(num_layers=5),
        "seamless_m4t_medium_smoke": jax_smoke_variant(
            jax_get_config("seamless-m4t-medium")),
        "tiny_dense": tiny_dense,
        "qwen3_8b_smoke": jax_smoke_variant(jax_get_config("qwen3-8b")),
        "qwen2_1_5b_smoke": jax_smoke_variant(jax_get_config("qwen2-1.5b")),
        "recurrentgemma_9b_smoke": hybrid,
        "recurrentgemma_9b_smoke_8_layers": hybrid.replace(num_layers=8),
        **{arch.replace("-", "_").replace(".", "_") + "_smoke":
           jax_smoke_variant(jax_get_config(arch)) for arch in NEW_ARCHS},
    }


# the other decoder families: dense (yi, chatglm3), parallel blocks
# (command-r), M-RoPE (qwen2-vl), MoE (mixtral, arctic)
NEW_ARCHS = ("yi-9b", "chatglm3-6b", "command-r-plus-104b", "qwen2-vl-2b",
             "mixtral-8x7b", "arctic-480b")


@pytest.mark.parametrize("name", [
    "tiny_dense", "qwen3_8b_smoke", "qwen2_1_5b_smoke",
    "recurrentgemma_9b_smoke", "recurrentgemma_9b_smoke_8_layers",
    "yi_9b_smoke", "chatglm3_6b_smoke", "command_r_plus_104b_smoke",
    "qwen2_vl_2b_smoke", "mixtral_8x7b_smoke", "arctic_480b_smoke",
    "xlstm_125m_smoke", "xlstm_125m_smoke_5_layers",
    "seamless_m4t_medium_smoke"])
def test_prefill_and_cached_block_match_jax(tiny_dense, name):
    jcfg = _configs(tiny_dense)[name]
    assert jcfg.dtype == "float32"
    cfg = port_cfg(jcfg)
    recurrent = JM.has_recurrent(jcfg)
    assert TM.has_recurrent(cfg) == recurrent
    # xLSTM takes the dense tolerance: a 1e-7 relative nudge of the 5-layer
    # cut's input embeddings moves the reference's own logits by 8.5e-5
    xlstm = "mlstm" in jcfg.block_pattern
    tol = TOL_HYBRID if recurrent and not xlstm else TOL
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
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **tol)
    _compare_caches(jcache, tcache, jcfg, tol)

    # one cached 5-token verify block; row 2 is inactive (trash-slot path)
    block = rng.integers(0, jcfg.vocab_size, size=(B, 5)).astype(np.int32)
    valid = np.ones((B, 5), bool)
    valid[2] = False
    jlog, jcache2, _ = JM.forward(
        jparams, jcfg, jnp.asarray(block), cache=jcache,
        valid=jnp.asarray(valid),
        commit_upto=None if recurrent else jnp.zeros((B,), jnp.int32),
        collect_states=recurrent,
    )
    tlog, tcache2 = TM.forward(params, cfg, torch.from_numpy(block),
                               cache=tcache, valid=torch.from_numpy(valid),
                               collect_states=recurrent)
    assert tlog.shape == (B, 5, jcfg.padded_vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **tol)
    if recurrent:  # gather at 1 + accepted per row, 0 for the inactive one
        n_commit = np.array([2, 5, 0], np.int32)
        jcache2 = JM.commit_staged_cache(jcfg, jcache2, jnp.asarray(n_commit))
        assert TM.commit_staged_cache(cfg, tcache, tcache2,
                                      torch.from_numpy(n_commit)) is tcache
        tcache2 = tcache
    _compare_caches(jcache2, tcache2, jcfg, tol)


@pytest.mark.parametrize("arch,n_layers", [("qwen3-8b", 2),
                                           ("recurrentgemma-9b", 6),
                                           *((a, 2) for a in NEW_ARCHS),
                                           ("xlstm-125m", 4),
                                           ("seamless-m4t-medium", 2)])
def test_init_params_shapes_and_scale(arch, n_layers):
    jcfg = jax_smoke_variant(jax_get_config(arch)).replace(
        num_layers=n_layers)
    cfg = port_cfg(jcfg)
    params = TM.init_params(cfg, seed=1, device="cpu")
    ref = jax.tree.map(np.asarray, make_params(jcfg))
    assert tuple(params.embed.shape) == ref["embed"].shape
    if "lm_head" in ref:
        assert tuple(params.lm_head.shape) == ref["lm_head"].shape
    else:
        assert params.lm_head is None and cfg.tie_embeddings
    unit, repeats = cfg.scan_stages[0]
    assert repeats > 1  # stage 0 is stacked: JAX leaves carry a layer axis
    for ui, kind in enumerate(unit):
        blk, jblk = params.layers[ui], ref["stages"][0][ui]
        assert blk.kind == kind
        assert sorted(blk.parts) == sorted(jblk)  # parallel: no mlp_norm

        def same_shapes(group, jgroup, path):
            assert sorted(group.keys()) == sorted(jgroup), path
            for k, v in group.items():
                if isinstance(v, torch.nn.ParameterDict):  # Arctic's dense
                    same_shapes(v, jgroup[k], path + (k,))
                    continue
                assert tuple(v.shape) == jgroup[k].shape[1:], path + (k,)
                assert v.dtype == torch.float32

        for group in blk.parts:
            same_shapes(getattr(blk, group), jblk[group], (group,))
        # N(0,1)/sqrt(fan_in): the std of wq (wx) is 1/sqrt(d_model), like
        # JAX's; an expert stack (E, d, f) takes its fan-in from d
        first = {"rglru": "wx", "mlstm": "wq", "slstm": "wz"}
        ws = [getattr(blk, kind)[first[kind]] if kind in first
              else blk.attn["wq"]]
        if "moe" in blk.parts:
            ws += [blk.moe["wi"], blk.moe["router"]]
        for w in ws:
            std = float(w.std())
            assert abs(std - 1 / np.sqrt(cfg.d_model)) < 0.1 / np.sqrt(
                cfg.d_model)
        if kind == "rglru":  # Λ's init is deterministic
            np.testing.assert_allclose(blk.rglru["lam"].numpy(),
                                       jblk["rglru"]["lam"][0], rtol=1e-5)
            assert abs(float(blk.rglru["conv"].std()) - 0.5) < 0.05
    if cfg.is_encoder_decoder:  # encoder blocks stacked in the reference
        assert len(params.encoder) == cfg.num_encoder_layers
        for blk in params.encoder:
            assert blk.parts == TM.ENC_PARTS
            for group in blk.parts:
                for k, v in getattr(blk, group).items():
                    assert (tuple(v.shape) == ref["encoder"]["blocks"][group]
                            [k].shape[1:]), (group, k)
    else:
        assert len(params.encoder) == 0 and "encoder" not in ref
    assert TM.param_count(params) == sum(a.size for a in jax.tree.leaves(ref))


def test_cached_forward_without_collect_commits_every_step():
    """A hybrid model's cached forward without ``collect_states`` writes
    each recurrent layer's state after the whole block into the cache, in
    place: the states ``commit_staged_cache`` gathers at n_commit = T."""
    cfg = port_cfg(jax_smoke_variant(jax_get_config("recurrentgemma-9b")))
    params = TM.init_params(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 6)))
    mask = torch.ones((2, 6), dtype=torch.bool)
    block = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 4)))
    caches = [TM.prefill(params, cfg, toks, mask, max_len=32)[1]
              for _ in range(2)]
    la, ca = TM.forward(params, cfg, block, cache=caches[0])
    lb, staged = TM.forward(params, cfg, block, cache=caches[1],
                            collect_states=True)
    TM.commit_staged_cache(cfg, caches[1], staged, torch.full((2,), 4))
    assert torch.equal(la, lb)
    for kind, a, b in zip(cfg.layer_kinds, ca.layers, caches[1].layers):
        pairs = ([(a[k], b[k]) for k in ("h", "conv")] if kind == "rglru"
                 else zip(a, b))
        for x, y in pairs:
            assert torch.equal(x, y), kind
    assert all(x is y for x, y in zip(ca.layers[0].values(),
                                      caches[0].layers[0].values()))


def test_bfloat16_leaves_cross_bit_exactly():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 17), jnp.bfloat16))
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_no_card_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg = jax_smoke_variant(jax_get_config("qwen3-8b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_params(port_cfg(jcfg), seed=0)
