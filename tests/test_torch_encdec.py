"""The port's encoder-decoder (SeamlessM4T-medium's smoke variant: 2
encoder and 2 decoder layers, d 256, 4 heads of 64, GELU MLPs) against
the JAX package on the same weights (float32, the tolerance of
tests/test_torch_model.py's dense configs):

* ``encode`` over stub frame embeddings with a ragged mask, and
  ``build_cross_cache``'s K/V, layer by layer;
* tests/test_models.py:198 on both sides: a full ``forward(enc_out=)``
  and a 3-token ``prefill(enc_out=)``; then greedy-free decoding of the
  rest, one token a step through the ring cache and the cross cache,
  each step's logits equal to the full forward's and the reference's
  cross-cached step's;
* the bidirectional encoder attention never takes the flash path, at
  T = 2048 too;
* ``params_from_numpy`` / ``params_to_numpy`` round trips for the
  encoder-decoder and for xLSTM, ``check_supported`` refusing none of the
  reference's configs, and ``init_params`` giving the reference's
  shapes at the published widths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_params
from repro.configs import REGISTRY as JREGISTRY
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy, params_to_numpy

TOL = dict(atol=2e-4, rtol=2e-4)
JCFG = jax_smoke_variant(jax_get_config("seamless-m4t-medium"))
_jforward = jax.jit(JM.forward, static_argnums=1)


@pytest.fixture(scope="module")
def model():
    jp = make_params(JCFG, seed=6)
    cfg = ModelConfig(**dataclasses.asdict(JCFG))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    rng = np.random.default_rng(7)
    B, S = 2, 9
    emb = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    mask = np.ones((B, S), bool)
    mask[1, 6:] = False  # a short utterance
    jenc = JM.encode(jp, JCFG, jnp.asarray(emb), jnp.asarray(mask))
    tenc = TM.encode(tp, cfg, torch.from_numpy(emb), torch.from_numpy(mask))
    return jp, cfg, tp, mask, jenc, tenc


def test_encode_and_cross_cache_match_jax(model):
    jp, cfg, tp, mask, jenc, tenc = model
    assert tenc.dtype == torch.float32 and tuple(tenc.shape) == jenc.shape
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), **TOL)
    jx = JM.build_cross_cache(jp, JCFG, jenc)
    tx = TM.build_cross_cache(tp, cfg, tenc)
    assert len(tx) == cfg.num_layers
    jl = []  # the reference's per-stage tuples, unstacked per layer
    for si, (unit, repeats) in enumerate(JCFG.scan_stages):
        for r in range(repeats):
            for ui in range(len(unit)):
                jl.append([np.asarray(a[r] if repeats > 1 else a)
                           for a in jx[si][ui]])
    for (tk, tv), (jk, jv) in zip(tx, jl):
        np.testing.assert_allclose(tk.numpy(), jk, **TOL)
        np.testing.assert_allclose(tv.numpy(), jv, **TOL)


def test_cross_cached_decode_matches_full_forward_and_jax(model):
    jp, cfg, tp, mask, jenc, tenc = model
    B, T, P = 2, 8, 3
    toks = np.asarray(jax.random.randint(jax.random.key(3), (B, T), 0,
                                         cfg.vocab_size), np.int32).copy()
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    jfull = np.asarray(_jforward(jp, JCFG, jnp.asarray(toks), enc_out=jenc,
                                 enc_mask=jm)[0])
    full = TM.forward(tp, cfg, torch.from_numpy(toks), enc_out=tenc,
                      enc_mask=tm)[0].numpy()
    np.testing.assert_allclose(full, jfull, **TOL)
    # without an encoder output the cross-attention is skipped, as there
    bare = TM.forward(tp, cfg, torch.from_numpy(toks))[0].numpy()
    np.testing.assert_allclose(
        bare, np.asarray(_jforward(jp, JCFG, jnp.asarray(toks))[0]), **TOL)
    assert np.abs(bare - full).max() > 1e-2
    last, cache = TM.prefill(tp, cfg, torch.from_numpy(toks[:, :P]),
                             torch.ones((B, P), dtype=torch.bool),
                             max_len=16, enc_out=tenc, enc_mask=tm)
    jlast, jcache = JM.prefill(jp, JCFG, jnp.asarray(toks[:, :P]),
                               jnp.ones((B, P), bool), max_len=16,
                               enc_out=jenc, enc_mask=jm)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
    np.testing.assert_allclose(last.numpy(), full[:, P - 1], **TOL)
    tx = TM.build_cross_cache(tp, cfg, tenc)
    jx = JM.build_cross_cache(jp, JCFG, jenc)
    one = np.ones((B, 1), bool)
    for t in range(P, T):
        feed = toks[:, t:t + 1]
        lg, cache = TM.forward(tp, cfg, torch.from_numpy(feed), cache=cache,
                               valid=torch.from_numpy(one), cross_cache=tx,
                               enc_mask=tm)
        jlg, jcache, _ = _jforward(jp, JCFG, jnp.asarray(feed), cache=jcache,
                                   valid=jnp.asarray(one), cross_cache=jx,
                                   enc_mask=jm)
        cache.lengths += 1
        jcache = jcache._replace(lengths=jcache.lengths + 1)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t], **TOL)


def test_bidirectional_attention_never_takes_flash(monkeypatch):
    """At T = 2048 a causal full-sequence forward takes the flash path; the
    encoder's bidirectional one stays on ``_attn_core`` with its mask."""
    def no_flash(*a, **k):
        raise AssertionError("bidirectional attention took the flash path")

    monkeypatch.setattr(TL, "_flash_attn_train", no_flash)
    jcfg = JCFG.replace(d_model=32, num_heads=2, num_kv_heads=2,
                        head_dim=16)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = JL.split_tree(JL.init_attention(jax.random.key(2), jcfg))[0]
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    B, T = 1, 2048
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    valid = np.ones((B, T), bool)
    valid[0, 1500:] = False
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    jy, _ = JL.attention_forward(jp, jnp.asarray(x), jcfg,
                                 positions=jnp.asarray(pos),
                                 bidirectional=True, valid=jnp.asarray(valid))
    ty, _ = TL.attention_forward(tp, torch.from_numpy(x), cfg,
                                 positions=torch.from_numpy(pos),
                                 bidirectional=True,
                                 valid=torch.from_numpy(valid))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "xlstm-125m"])
def test_params_round_trip(arch):
    jcfg = jax_smoke_variant(jax_get_config(arch))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = jax.tree.map(np.asarray, make_params(jcfg, seed=8))
    tp = params_from_numpy(jp, cfg, "cpu")
    back = params_to_numpy(tp, cfg)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jp))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, a, err_msg=str(path))
    again = params_from_numpy(back, cfg, "cpu")
    for (na, a), (nb, b) in zip(tp.named_parameters(),
                                again.named_parameters()):
        assert na == nb and torch.equal(a, b)


def test_every_reference_config_is_supported():
    """``check_supported`` refuses none of the reference's configs, and
    ``init_params`` builds the two new families with the reference's
    parameter shapes: xLSTM-125M whole, SeamlessM4T-medium at its widths
    with one encoder and one decoder layer and a 1,024-entry vocabulary
    (its whole 256,206-entry embedding and head are built on the card,
    by ``chip_smoke.py``)."""
    for name in JREGISTRY:
        TM.check_supported(get_config(name))
    cut = dict(num_layers=1, num_encoder_layers=1, vocab_size=1024)
    for name, over in (("xlstm-125m", {}), ("seamless-m4t-medium", cut)):
        cfg = get_config(name).replace(**over)
        params = TM.init_params(cfg, seed=0, device="cpu")
        assert len(params.layers) == cfg.num_layers
        assert len(params.encoder) == cfg.num_encoder_layers
        ref = JL.split_tree(JM.param_shapes(
            jax_get_config(name).replace(**over)))[0]
        want = sorted(a.shape for a in jax.tree.leaves(ref))
        got = params_to_numpy(params, cfg)
        assert sorted(a.shape for a in jax.tree.leaves(got)) == want
        assert TM.param_count(params) == sum(int(np.prod(a.shape))
                                             for a in jax.tree.leaves(ref))
