"""The port's learner against the JAX package on the same numpy inputs
(float32 unless stated):

* ``group_advantages``, ``token_logprobs`` and ``chunked_token_logprobs``
  (atol 1e-5, rtol 1e-5);
* ``grpo_loss`` and its gradients with respect to every parameter
  (through ``params_to_numpy``) against ``jax.value_and_grad``: loss
  within rtol 1e-5, gradients within atol 1e-5, rtol 1e-3; cases: the
  plain surrogate with clipping active, KL and entropy terms on, and
  S = 2048 (every attention through the flash backward), for the dense
  decoder and for the hybrid (RecurrentGemma-9B's smoke pattern at the
  same small width: two RG-LRU layers, whose gradient runs through the
  scan's backward, and a local-attention layer of window 64, through the
  flash backward past the window at S = 2048), for Mixtral's smoke
  pattern (MoE, its load-balance loss in the loss and the metrics) and
  for the Qwen2-VL backbone on a batch of stub ``embeds`` with three
  distinct M-RoPE position streams, for xLSTM's smoke pattern (mLSTM
  and sLSTM blocks, no MLP; the gradient runs back through both loops)
  and for the encoder-decoder on a batch of stub ``enc_embeds`` with a
  ragged ``enc_mask`` (the encoder runs first, the decoder
  cross-attends); loss and gradients all finite; ``remat=True`` gives
  the ``remat=False`` loss and gradients exactly, for the dense decoder,
  the hybrid, the MoE, xLSTM and the encoder-decoder;
* three AdamW steps (warmup, cosine, weight decay and clipping all
  active) against ``apply_updates``: parameters, ``mu``, ``nu`` and the
  three metrics, float32 within rtol 1e-5, and bfloat16 parameters (the
  cast back to the parameter's dtype) within one bf16 ulp;
* one SFT step against ``make_sft_step``, dense and hybrid;
* checkpoint round trip, and its three refusals.
"""

import copy
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
from repro.optim import adamw as jadamw
from repro.rl import grpo as jgrpo
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.optim import adamw
from repro_torch.rl import grpo

LP_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)


def _cfgs(arch="qwen2-1.5b", **over):
    jcfg = jax_smoke_variant(jax_get_config(arch)).replace(**over)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


SMALL = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
             vocab_size=96, vocab_pad_multiple=32)
# the hybrid at the same width: rglru, rglru, local_attn (window 64), MQA
HYBRID = dict(SMALL, arch="recurrentgemma-9b", num_kv_heads=1, rnn_width=64)
# MoE at the same width: 4 experts, top 2, window 64
MOE = dict(SMALL, arch="mixtral-8x7b")
# the VLM backbone: M-RoPE sections summing to the rotary half of hd 16
VLM = dict(SMALL, arch="qwen2-vl-2b", mrope_sections=(2, 3, 3))
# xLSTM at the same width: mlstm, slstm, 4 heads of 16, no MLP
XLSTM = dict(SMALL, arch="xlstm-125m", d_ff=0, rnn_width=64)
# the encoder-decoder: 2 encoder and 2 decoder layers, GELU MLPs
ENCDEC = dict(SMALL, arch="seamless-m4t-medium")


def _params(jcfg, cfg, seed=0, dtype=None):
    jparams = make_params(jcfg, seed=seed)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jparams, TM.set_trainable(params)


def _batch(cfg, B, S, seed, noise=0.3):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(2, cfg.vocab_size, size=(B, S)).astype(np.int32)
    plen = rng.integers(3, S // 2, size=B)
    rlen = rng.integers(1, S - plen)
    resp = np.zeros((B, S), bool)
    for b in range(B):
        resp[b, plen[b]:plen[b] + rlen[b]] = True
    adv = rng.normal(size=B).astype(np.float32)
    old_noise = (noise * rng.normal(size=(B, S))).astype(np.float32)
    return tokens, resp, adv, old_noise


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grads_tree(params, grads, cfg):
    g = copy.deepcopy(params)
    with torch.no_grad():
        for name, p in g.named_parameters():
            p.copy_(grads[name])
    return params_to_numpy(g, cfg)


def test_group_advantages_match_jax():
    r = np.random.default_rng(0).normal(size=24).astype(np.float32)
    np.testing.assert_allclose(grpo.group_advantages(r, 4),
                               jgrpo.group_advantages(r, 4), **LP_TOL)


def test_logprobs_match_jax():
    jcfg, cfg = _cfgs(**SMALL)
    jparams, params = _params(jcfg, cfg, seed=1)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 37)).astype(np.int32)
    jh, _, _ = JM.forward(jparams, jcfg, jnp.asarray(toks), return_hidden=True)
    jl, _, _ = JM.forward(jparams, jcfg, jnp.asarray(toks))
    want_c = jgrpo.chunked_token_logprobs(jparams, jcfg, jh, jnp.asarray(toks),
                                          chunk=8)
    want_d = jgrpo.token_logprobs(jl[:, :, :cfg.vocab_size], jnp.asarray(toks))
    t = torch.from_numpy(toks)
    with torch.no_grad():
        th, _ = TM.forward(params, cfg, t, return_hidden=True)
        tl, _ = TM.forward(params, cfg, t)
        got_c = grpo.chunked_token_logprobs(params, cfg, th, t, chunk=8)
        got_d = grpo.token_logprobs(tl[:, :, :cfg.vocab_size], t)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **LP_TOL)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **LP_TOL)
    # with grad on, the chunks are checkpointed: same values
    th2, _ = TM.forward(params, cfg, t, return_hidden=True)
    got_g = grpo.chunked_token_logprobs(params, cfg, th2, t, chunk=8)
    np.testing.assert_allclose(got_g.detach().numpy(), got_c.numpy(),
                               atol=0, rtol=0)


GRPO_CASES = {
    "surrogate": (dict(), dict(), 4, 40),
    "kl_entropy": (dict(kl_coef=0.05, entropy_coef=0.01), dict(), 4, 40),
    "flash_2048": (dict(kl_coef=0.05), dict(num_layers=2), 2, 2048),
    "hybrid_surrogate": (dict(), HYBRID, 4, 40),
    # 3 layers: 2 would hold no attention layer
    "hybrid_flash_2048": (dict(kl_coef=0.05), HYBRID, 2, 2048),
    "moe_surrogate": (dict(), MOE, 4, 40),
    "vlm_embeds": (dict(), VLM, 4, 40),
    "xlstm_surrogate": (dict(kl_coef=0.05), XLSTM, 4, 40),
    "encdec_enc_embeds": (dict(kl_coef=0.05), ENCDEC, 4, 40),
}


def _modality_inputs(cfg, B, S, seed):
    """Stub vision embeddings and three distinct position streams, or an
    encoder-decoder's stub frames (S + 3 of them, the last row's mask cut
    short)."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder_decoder:
        enc = rng.normal(size=(B, S + 3, cfg.d_model)).astype(np.float32)
        mask = np.ones((B, S + 3), bool)
        mask[-1, S // 2:] = False
        return {"enc_embeds": enc, "enc_mask": mask}
    embeds = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    t = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    pos3 = np.stack([t, rng.integers(0, S, size=(B, S)),
                     rng.integers(0, S, size=(B, S))]).astype(np.int32)
    return {"embeds": embeds, "mrope_positions": pos3}


@pytest.mark.parametrize("case", sorted(GRPO_CASES))
def test_grpo_loss_and_grads_match_jax(case):
    gkw, ckw, B, S = GRPO_CASES[case]
    jcfg, cfg = _cfgs(**{**SMALL, **ckw})
    jparams, params = _params(jcfg, cfg, seed=2)
    tokens, resp, adv, noise = _batch(cfg, B, S, seed=3)
    # the reference runs jitted, as its train step does
    jold = np.asarray(jax.jit(jgrpo.compute_old_logprobs, static_argnums=1)(
        jparams, jcfg, jnp.asarray(tokens)))
    told = grpo.compute_old_logprobs(params, cfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(told.numpy(), jold, **LP_TOL)
    # (both references score without the encoder: the ratios' old side)
    old = jold + noise  # ratios away from 1: clipping is active
    jg = jgrpo.GRPOConfig(**gkw)
    jbatch = {"tokens": jnp.asarray(tokens), "resp_mask": jnp.asarray(resp),
              "advantages": jnp.asarray(adv), "old_logprobs": jnp.asarray(old)}
    tb = {"tokens": torch.from_numpy(tokens), "resp_mask": torch.from_numpy(resp),
          "advantages": torch.from_numpy(adv),
          "old_logprobs": torch.from_numpy(old)}
    if cfg.rope == "mrope" or cfg.is_encoder_decoder:
        extra = _modality_inputs(cfg, B, S, seed=4)
        jbatch.update({k: jnp.asarray(v) for k, v in extra.items()})
        tb.update({k: torch.from_numpy(v) for k, v in extra.items()})
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jgrpo.grpo_loss(p, jcfg, jg, jbatch), has_aux=True))(jparams)
    if cfg.num_experts:
        assert float(jm["aux_loss"]) > 0
    loss, m = grpo.grpo_loss(params, cfg, grpo.GRPOConfig(**gkw), tb)
    grads = grpo.param_grads(params, loss)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5, atol=1e-7)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = _flat(jgrads)
    got = _flat(_grads_tree(params, grads, cfg))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)
    assert all(np.abs(v).max() > 0 for v in got.values())
    assert np.isfinite(float(loss)) and all(
        np.isfinite(v).all() for v in got.values())


def _remat_gives_the_same_grads(over):
    jcfg, cfg = _cfgs(**over)
    _, params = _params(jcfg, cfg, seed=5)
    tokens, resp, adv, noise = _batch(cfg, 4, 40, seed=6)
    tb = {"tokens": torch.from_numpy(tokens), "resp_mask": torch.from_numpy(resp),
          "advantages": torch.from_numpy(adv),
          "old_logprobs": torch.from_numpy(noise)}
    if cfg.is_encoder_decoder:
        tb.update({k: torch.from_numpy(v) for k, v in
                   _modality_inputs(cfg, 4, 40, seed=7).items()})
    out = []
    for remat in (False, True):
        g = grpo.GRPOConfig(kl_coef=0.05, remat=remat)
        loss, _ = grpo.grpo_loss(params, cfg, g, tb)
        out.append((float(loss), grpo.param_grads(params, loss)))
    assert out[0][0] == out[1][0]
    for k, g0 in out[0][1].items():
        assert torch.equal(g0, out[1][1][k]), k


def test_grpo_remat_gives_the_same_grads():
    _remat_gives_the_same_grads(SMALL)


def test_grpo_remat_gives_the_same_grads_hybrid():
    _remat_gives_the_same_grads(HYBRID)


def test_grpo_remat_gives_the_same_grads_moe():
    """The load-balance loss comes out of each checkpointed block too."""
    _remat_gives_the_same_grads(MOE)


def test_grpo_remat_gives_the_same_grads_xlstm():
    _remat_gives_the_same_grads(XLSTM)


def test_grpo_remat_gives_the_same_grads_encdec():
    """The encoder's output reaches each checkpointed decoder block."""
    _remat_gives_the_same_grads(ENCDEC)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_three_steps_match_jax(dtype):
    rng = np.random.default_rng(7)
    shapes = {"a": (16, 8), "b": (8,), "c": (3, 4, 5)}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jparams = {k: jnp.asarray(rng.normal(size=s), jdt)
               for k, s in shapes.items()}
    params = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        getattr(torch, dtype)) for k, v in jparams.items()}
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.1,
                grad_clip=1.0)
    jstate = jadamw.init_state(jparams)
    state = adamw.init_state(params)
    for step in range(3):
        gs = {k: rng.normal(size=s) * (3.0 if step == 0 else 0.05)
              for k, s in shapes.items()}  # step 1 clips, the others not
        jgrads = {k: jnp.asarray(g, jdt) for k, g in gs.items()}
        grads = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
            getattr(torch, dtype)) for k, v in jgrads.items()}
        jparams, jstate, jm = jadamw.apply_updates(
            jadamw.AdamWConfig(**ocfg), jparams, jgrads, jstate)
        params, state, m = adamw.apply_updates(
            adamw.AdamWConfig(**ocfg), params, grads, state)
        for k in ("grad_norm", "lr", "update_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        assert int(state.step) == int(jstate.step) == step + 1
        for k in shapes:
            np.testing.assert_allclose(state.mu[k].numpy(),
                                       np.asarray(jstate.mu[k]), rtol=1e-5,
                                       atol=1e-7)
            np.testing.assert_allclose(state.nu[k].numpy(),
                                       np.asarray(jstate.nu[k]), rtol=1e-5,
                                       atol=1e-9)
            assert params[k].dtype == getattr(torch, dtype)
            got = params[k].float().numpy()
            want = np.asarray(jparams[k].astype(jnp.float32))
            if dtype == "float32":
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
            else:  # the float32 update rounds to bf16: at most one ulp
                np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
    assert float(m["update_norm"]) > 0


def test_schedule_matches_jax():
    cfg = dict(lr=3e-4, warmup_steps=3, total_steps=10, min_lr_frac=0.2)
    for s in range(12):
        np.testing.assert_allclose(
            float(adamw.schedule(adamw.AdamWConfig(**cfg), s)),
            float(jadamw.schedule(jadamw.AdamWConfig(**cfg),
                                  jnp.asarray(s, jnp.int32))), rtol=1e-6)


def _jax_sft_grads(jparams, jcfg, tokens, resp):
    """The SFT cross-entropy's gradient, as ``make_sft_step`` takes it."""
    def ce(p):
        h, _, _ = JM.forward(p, jcfg, jnp.asarray(tokens), return_hidden=True)
        lp = jgrpo.chunked_token_logprobs(p, jcfg, h, jnp.asarray(tokens))
        m = jnp.asarray(resp).astype(jnp.float32)
        return -(lp * m).sum() / jnp.maximum(m.sum(), 1.0)

    return _flat(jax.grad(ce)(jparams))


def _sft_step_matches_jax(over, near_eps=False):
    jcfg, cfg = _cfgs(**over)
    jparams, params = _params(jcfg, cfg, seed=8)
    tokens, resp, _, _ = _batch(cfg, 4, 40, seed=9)
    ocfg = dict(lr=3e-3, warmup_steps=2)
    jstep = jgrpo.make_sft_step(jcfg, jadamw.AdamWConfig(**ocfg))
    jp, _, jm = jstep(jparams, jadamw.init_state(jparams),
                      {"tokens": jnp.asarray(tokens),
                       "resp_mask": jnp.asarray(resp)})
    step = grpo.make_sft_step(cfg, adamw.AdamWConfig(**ocfg))
    params, _, m = step(params, adamw.init_state(params),
                        {"tokens": torch.from_numpy(tokens),
                         "resp_mask": torch.from_numpy(resp)})
    for k in ("sft_loss", "grad_norm", "lr", "update_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    # Adam's first step is about lr * sign(g): where |g| is near noise
    # (the key bias under RoPE) the two sides may step apart by a little;
    # hold every weight within 1% of one step
    want, got = _flat(jp), _flat(params_to_numpy(params, cfg))
    # with ``near_eps``: where JAX's gradient is within 10 eps of 0, the
    # step g / (|g| + eps) turns on the gradient's last digits, which the
    # two sides round differently: there the bound is one whole step
    jg = _jax_sft_grads(jparams, jcfg, tokens, resp) if near_eps else None
    eps = adamw.AdamWConfig().eps
    for k in want:
        atol = 0.01 * ocfg["lr"]
        if near_eps:
            atol = np.where(np.abs(jg[k]) < 10 * eps, ocfg["lr"], atol)
        bad = ~(np.abs(got[k] - want[k]) <= atol + 1e-5 * np.abs(want[k]))
        assert not bad.any(), (k, got[k][bad], want[k][bad])


def test_sft_step_matches_jax():
    _sft_step_matches_jax(SMALL)


def test_sft_step_matches_jax_hybrid():
    _sft_step_matches_jax(HYBRID, near_eps=True)


def _bf16_model():
    jcfg, cfg = _cfgs(**SMALL, dtype="bfloat16")
    return cfg, TM.init_params(cfg, seed=0, device="cpu")


def test_checkpoint_round_trip(tmp_path):
    cfg, params = _bf16_model()
    opt = adamw.init_state(params)
    for k in opt.mu:
        opt.mu[k].normal_()
    opt = opt._replace(step=torch.tensor(3, dtype=torch.int32))
    path = str(tmp_path / "c.npz")
    ckpt.save(path, {"params": params, "opt": opt}, metadata={"step": 3},
              sidecar={"x": [1, 2]})
    cfg2, fresh = _bf16_model()
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    tree, meta = ckpt.load(path, {"params": fresh,
                                  "opt": adamw.init_state(fresh)})
    assert meta == {"step": 3}
    assert tree["params"] is fresh
    for (n, a), (_, b) in zip(params.named_parameters(),
                              fresh.named_parameters()):
        assert b.dtype == a.dtype and torch.equal(a, b), n
    assert fresh.embed.dtype == torch.bfloat16
    assert int(tree["opt"].step) == 3
    for k in opt.mu:
        assert torch.equal(tree["opt"].mu[k], opt.mu[k])
    assert ckpt.load_sidecar(path) == {"x": [1, 2]}
    with np.load(path) as zf:
        assert "params/layers/0/attn/wq" in zf.files
        assert "opt/mu/layers.0.attn.wq" in zf.files


def test_checkpoint_refusals(tmp_path):
    cfg, params = _bf16_model()
    plain = str(tmp_path / "plain.npz")
    ckpt.save(plain, {"params": params})
    with pytest.raises(KeyError, match="no sidecar"):
        ckpt.load_sidecar(plain)
    with pytest.raises(ValueError, match="schema_version"):
        ckpt.save(str(tmp_path / "v.npz"), {"w": torch.zeros(2)},
                  sidecar={"a": 1})
        ckpt.load_sidecar(str(tmp_path / "v.npz"), expected_version=2)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load(str(tmp_path / "v.npz"), {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="reserved"):
        ckpt.save(str(tmp_path / "r.npz"), {"__sidecar__": torch.zeros(1)})
