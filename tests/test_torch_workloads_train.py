"""The port's GRPO train step (``workloads.make_train_fn``: GRPO with
remat, then AdamW at lr 3e-4) against the reference's
(``repro.launch.workloads.make_train_fn``, jitted), at small widths on
the same weights and the same numpy batch, float32: the loss within rtol
1e-5 and every updated weight within 1% of one Adam step (Adam's first
step is about lr · sign(g), as in ``tests/test_torch_grpo.py``), for
Qwen2-1.5B's and SeamlessM4T's patterns (the encoder over stub
``enc_embeds`` with a ragged ``enc_mask``).
"""

import jax
import numpy as np
import pytest

from repro.launch import workloads as JW
from repro.optim import adamw as jadamw
from repro_torch.launch import workloads as W
from repro_torch.models.convert import params_to_numpy
from repro_torch.optim import adamw
from test_torch_workloads import S_ENC, _both, _enc_inputs, _models, _weights


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["qwen2", "encdec"])
def test_train_step_matches_the_reference(family):
    jcfg, cfg, jparams, params = _models(family, trainable=True)
    rng = np.random.default_rng(3)
    Bt, S = 8, 24
    tokens = rng.integers(2, cfg.vocab_size, size=(Bt, S)).astype(np.int32)
    resp = np.zeros((Bt, S), bool)
    resp[:, 10:] = True
    batch = {"tokens": tokens, "resp_mask": resp,
             "advantages": rng.normal(size=(Bt,)).astype(np.float32),
             # ratios away from 1 so that the clip bites on some tokens
             "old_logprobs": (rng.normal(size=(Bt, S)) * 0.3
                              - 4.6).astype(np.float32)}
    if cfg.is_encoder_decoder:
        enc = _enc_inputs(rng, cfg, "enc_embeds")
        enc["enc_mask"] = np.repeat(enc["enc_mask"], 3, 0)[:Bt]
        enc["enc_embeds"] = rng.normal(
            size=(Bt, S_ENC, cfg.d_model)).astype(np.float32)
        batch.update(enc)
    jb, tb = _both(batch)
    jp, _, jloss = jax.jit(JW.make_train_fn(jcfg))(
        jparams, jadamw.init_state(jparams), jb)
    params, state, loss = W.make_train_fn(cfg)(params,
                                               adamw.init_state(params), tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-7)
    assert int(state.step) == 1
    lr = 3e-4
    want = jax.tree.leaves(jax.tree.map(np.asarray, jp))
    got = jax.tree.leaves(params_to_numpy(params, cfg))
    assert len(want) == len(got)
    moved = 0
    for w, g, w0 in zip(want, got, jax.tree.leaves(_weights(family))):
        # Adam's first step is lr · g / (|g| + eps) (after the clip's
        # scale): where the reference stepped less than 0.95 lr, |g| is
        # within 20 eps of 0 and the step turns on the gradient's last
        # digits, which the two sides round differently: there the bound
        # is one whole step, elsewhere 1% of one
        atol = np.where(np.abs(w - w0) < 0.95 * lr, lr, 0.01 * lr)
        bad = ~(np.abs(g - w) <= atol + 1e-5 * np.abs(w))
        assert not bad.any(), (g[bad], w[bad])
        moved += int((np.abs(g - w0) > 0.5 * lr).sum())
    assert moved > 0
