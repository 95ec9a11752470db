"""Host-side helpers of ``chip_smoke.py``, on the CPU.

The suffix-match bound counts the forest entries a per-row walk of the
kernels' row core reads (``walk_needed_reads``); the walk must compute
the same outputs as the plain version, or the count would not be of the
kernel's work. Integers only: bit-identical. The RG-LRU scan's bound
counts the bytes of the steps its mask updates, counted here by hand;
its launches split by shape into the JSON line's entries. The scan's
backward bound counts x, r, i and h_{t-1} at the updated steps and the
rest at every step. Phases 10 to 13 are rehearsed at small widths on
the CPU, where the kernels' plain versions run and the launch gates are
off.
"""

import importlib.util
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.suffix_match.ref import (
    suffix_match_propose_chunked_ref,
    suffix_match_propose_ref,
)

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("min_match", [1, 3])
@pytest.mark.parametrize("layout", ["flat", "chunked"])
def test_read_walk_equals_plain_version(layout, min_match):
    cs = _chip_smoke()
    cf, ff, args, flat_roots, _ = cs.chunked_case(
        torch, np, "cpu", n_problems=6, B=24, m=24, K=8, doc_len=(60, 120))
    kw = dict(n_prop_max=8, min_match=min_match)
    if layout == "chunked":
        forest, q = cf, args
        want = suffix_match_propose_chunked_ref(*q, *cf, **kw)
    else:
        forest, q = ff, (args[0], flat_roots, args[2])
        want = suffix_match_propose_ref(*q, *ff, **kw)
    outs, entries, n_query = cs.walk_needed_reads(
        np, *q, forest, chunked=layout == "chunked", **kw)
    for w, g in zip(want, outs):
        np.testing.assert_array_equal(w.numpy(), g)
    assert int(want[1].sum()) > 0  # the case proposes something
    active = int((q[1] >= 0).sum())
    assert n_query == 24 + active * (24 + 1)
    assert 0 < entries < sum(t.numel() for t in forest)
    ms, entries2 = cs.suffix_match_bound_ms(
        np, want, *q, forest, chunked=layout == "chunked", **kw)
    assert entries2 == entries and ms > 0


# ---- the RG-LRU scan's bound and its launches by shape -------------------

def test_rglru_bound_counts_the_updated_steps_bytes():
    """B 2, T 3, W 5: without a mask x, r, i and hs at all 6 steps, h0,
    h_final and Λ (4 bytes each); with a mask that updates 2 steps, x, r
    and i at those 2, hs at all 6, and the 6 mask bytes."""
    cs = _chip_smoke()
    x = torch.zeros(2, 3, 5)
    want = 4 * (4 * 6 * 5 + 2 * 2 * 5 + 5)  # 580
    assert cs.rglru_bytes(2, 3, 5, None) == (want, 6)
    ms, by = cs.rglru_bound_ms(x, None)
    assert by == "bytes" and ms == pytest.approx(want / 3.35e12 * 1e3)
    mask = torch.tensor([[False, True, True], [False, False, False]])
    want = 4 * (3 * 2 * 5 + 6 * 5 + 2 * 2 * 5 + 5) + 6  # 346
    assert cs.rglru_bytes(2, 3, 5, mask) == (want, 2)
    ms, by = cs.rglru_bound_ms(x, mask)
    assert by == "bytes" and ms == pytest.approx(want / 3.35e12 * 1e3)
    # reading every step, as before masked steps were skipped
    every = 4 * (4 * 6 * 5 + 2 * 2 * 5 + 5) + 6
    assert cs.rglru_bytes(2, 3, 5, mask, skip_masked=False) == (every, 6)
    ms, _ = cs.rglru_bound_ms(x, mask, skip_masked=False)
    assert ms == pytest.approx(every / 3.35e12 * 1e3)


def test_rglru_launches_split_by_shape_sum_to_the_total():
    """The kernels JSON line's two entries of the scan: verify rounds (T
    = 17, the path's one K bucket + 1) and every prefill (lock-step
    batches and admissions, any other T)."""
    cs = _chip_smoke()
    by_shape = Counter({(8, 17): 26 * 290, (8, 256): 26, (1, 256): 26 * 9,
                        (2, 240): 26 * 2, (1, 17): 0})
    verify, prefill = cs.rglru_launch_split(by_shape)
    assert (verify, prefill) == (26 * 290, 26 * 12)
    assert verify + prefill == sum(by_shape.values())
    assert cs.rglru_launch_split(Counter()) == (0, 0)
    assert cs.VERIFY_T == 17


@pytest.mark.parametrize("kind", ["left pads", "bucket pads",
                                  "rows masked out", "all kept", None])
def test_rglru_masks(kind):
    cs = _chip_smoke()
    B, T = 8, 256
    m = cs.rglru_mask(torch, np, kind, B, T, dev="cpu")
    if kind is None:
        assert m is None
        return
    assert tuple(m.shape) == (B, T) and m.dtype == torch.bool
    lens = m.sum(1)
    if kind == "rows masked out":
        assert lens.tolist() == [0 if b % 3 == 1 else T for b in range(B)]
        return
    # left-padded: each row's kept steps are a suffix
    assert all(m[b, T - int(n):].all() for b, n in enumerate(lens))
    lo = {"left pads": 64, "bucket pads": T - 15, "all kept": T}[kind]
    assert int(lens.min()) == lo and int(lens.max()) == T


def test_rglru_long_launches_are_a_part_of_the_prefill_count():
    """Phase 9's forwards at T >= 2048 (the GRPO step, long prefills) get
    their own JSON entry, taken out of the prefill count."""
    cs = _chip_smoke()
    by_shape = Counter({(8, 17): 40, (8, 256): 26, (4, 2208): 8,
                        (4, 2272): 12, (1, 2047): 3})
    verify, prefill = cs.rglru_launch_split(by_shape)
    long_n = cs.rglru_long_launches(by_shape)
    assert (verify, prefill, long_n) == (40, 49, 20)
    assert cs.rglru_long_launches(Counter()) == 0


def test_rglru_bwd_bound_counts_the_updated_steps_bytes():
    """B 2, T 3, W 5: without a mask 32 bytes a (b, t, w), then h0,
    dh_final and dh0 (3 x B x W) and Λ, dΛ (2 x W) in float32; with a mask
    that updates 2 steps, x, r, i and h_{t-1} at those 2 only, and the 6
    mask bytes."""
    cs = _chip_smoke()
    want = 4 * (8 * 6 * 5 + 3 * 2 * 5 + 2 * 5)  # 1,360
    assert cs.rglru_bwd_bytes(2, 3, 5, None) == (want, 6)
    ms, by = cs.rglru_bwd_bound_ms(2, 3, 5, None)
    assert by == "bytes" and ms == pytest.approx(want / 3.35e12 * 1e3)
    mask = torch.tensor([[False, True, True], [False, False, False]])
    want = 4 * (4 * 2 * 5 + 4 * 6 * 5 + 3 * 2 * 5 + 2 * 5) + 6  # 806
    assert cs.rglru_bwd_bytes(2, 3, 5, mask) == (want, 2)
    # the training shape: 32 bytes a (b, t, w), 1.19 GB, 0.36 ms
    nbytes, _ = cs.rglru_bwd_bytes(4, 2272, 4096, None)
    assert 1.19e9 < nbytes < 1.20e9
    assert cs.rglru_bwd_bound_ms(4, 2272, 4096, None)[0] == pytest.approx(
        nbytes / 3.35e12 * 1e3)


@pytest.mark.parametrize("T,want", [(0, 0), (1, 24_608), (32, 24_608),
                                    (33, 49_216), (2272, 49_216)])
def test_rglru_bwd_smem_is_a_stage_a_chunk_up_to_two(T, want):
    """A stage is six 32 x 32 float32 tiles and 32 mask bytes; the ring
    holds two (one for a single chunk). Two stages stay under the 56 KB
    a CTA that four CTAs an SM allow."""
    cs = _chip_smoke()
    assert cs.RGLRU_BWD_STAGE_BYTES == 6 * 4096 + 32
    assert cs.rglru_bwd_smem_bytes(T) == want
    assert 4 * (cs.rglru_bwd_smem_bytes(2272) + 1024) <= 228 * 1024


def test_rglru_bwd_waves():
    """The training shape's 4 x 128 = 512 CTAs fill one wave at four CTAs
    an SM on 132 SMs and need two at three; a ragged width rounds its
    last CTA up."""
    cs = _chip_smoke()
    assert cs.rglru_bwd_waves(4, 4096, 4, 132) == 1
    assert cs.rglru_bwd_waves(4, 4096, 3, 132) == 2
    assert cs.rglru_bwd_waves(8, 4096, 4, 132) == 2
    assert cs.rglru_bwd_waves(2, 4001, 1, 1) == 2 * 126
    assert cs.rglru_bwd_waves(1, 1, 4, 132) == 1


# ---------------------------------------------------------------------------
# phase 10's helpers rehearsed on the CPU at small widths
# ---------------------------------------------------------------------------

def _small_qwen3():
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import model as M

    cfg = smoke_variant(get_config("qwen3-8b")).replace(
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128)
    return cfg, M.init_params(cfg, seed=0, device="cpu")


_TRAFFIC = dict(slots=3, n_problems=4, n_requests=8, limits=(6, 10, 14, 18),
                prompt_len=(6, 10))


def test_phase10a_telemetry_and_10b_drain_resume_on_cpu():
    """10a: phase 5's traffic with telemetry and a journal equals the
    plain run (tokens, rounds, crossings; counters, journal, trace and
    attribution gated); 10b: the drain stops the serve early with
    finished, preempted and queued requests, and the recovered journal
    resumes to the uninterrupted run's outputs."""
    cs = _chip_smoke()
    cfg, params = _small_qwen3()
    _, runs, _, _, _ = cs.continuous_layouts(
        torch, np, cfg, params, "cpu", "cpu", layouts=("chunked",),
        **_TRAFFIC)
    assert runs[1]["accepted"] > 0
    _, tel = cs.phase_telemetry(torch, np, "cpu", cfg, params, runs, {},
                                dev="cpu", **_TRAFFIC)
    assert tel.registry.value("das_journal_appends_total") > 0
    cs.phase_drain_resume(torch, np, "cpu", cfg, params, dev="cpu",
                          drain_after=8, **_TRAFFIC)


def test_phase10_checks_fail_loudly():
    """A telemetry check that does not hold stops the run (a phase's
    error is never caught): the Prometheus parser reads what the check
    compares."""
    from repro_torch import obs

    cs = _chip_smoke()
    tel = obs.Telemetry()
    tel.counter("das_rounds_total", "rounds").inc(3)
    assert cs.prom_values(tel.prometheus())["das_rounds_total"] == 3.0
    with pytest.raises(SystemExit):
        cs.check(False, "10a: injected")


def test_phase10c_multiworker_on_cpu():
    """10c at a small width: two workers with a killed shard, a watchdog
    stall and a flaky call, token-identical to one worker, and a step-2
    checkpoint that resumes."""
    from repro_torch.configs import get_config, smoke_variant

    cs = _chip_smoke()
    cfg = smoke_variant(get_config("qwen2-1.5b")).replace(
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128)
    cs.phase_multiworker(torch, np, "cpu", cfg=cfg, dev="cpu",
                         max_new_tokens=12)


def test_phase10_bf16_witness_on_cpu():
    """10b and 10c in bf16, as ``main`` runs them beside the float32
    ones: the drain and resume against a continuous run's epoch 1 and the
    two-worker trainer against one worker, each gated by plain greedy's
    shortfalls (``TOL_LOGIT_BF16``) instead of token equality, with the
    engine spans and stack samples of step 3 in both trainers, and no
    checkpoint."""
    from repro_torch.configs import get_config, smoke_variant

    from repro_torch.models import model as M

    cs = _chip_smoke()
    cfg = _small_qwen3()[0].replace(dtype="bfloat16")
    params = M.init_params(cfg, seed=0, device="cpu")
    _, runs, _, _, _ = cs.continuous_layouts(
        torch, np, cfg, params, "cpu", "cpu", layouts=("chunked",),
        **_TRAFFIC)
    cs.phase_drain_resume(torch, np, "cpu", cfg, params, dev="cpu",
                          drain_after=8, reference=runs[0], **_TRAFFIC)
    cfg2 = smoke_variant(get_config("qwen2-1.5b")).replace(
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        dtype="bfloat16")
    cs.phase_multiworker(torch, np, "cpu", cfg=cfg2, dev="cpu",
                         max_new_tokens=12, resume=False)


# ---------------------------------------------------------------------------
# phase 11's helpers rehearsed on the CPU at small widths
# ---------------------------------------------------------------------------

def _small(arch, **over):
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import model as M

    cfg = smoke_variant(get_config(arch)).replace(
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        **over)
    return cfg, M.init_params(cfg, seed=0, device="cpu")


def test_phase11_families_on_cpu():
    """11c (parallel blocks: epoch identity and the plain-greedy witness)
    and 11e (MoE: the ``apply_moe`` spy's kept calls replayed through the
    plain float32 layer, in lock-step and, at a smaller traffic than the
    card's, in continuous serving) at small widths; then 11d's embeds
    forward, M-RoPE check and GRPO step on the Qwen2-VL backbone."""
    cs = _chip_smoke()
    traffic = dict(dev="cpu", limits=(8, 16), prompt_len=(6, 12))
    cfg, params = _small("command-r-plus-104b")
    launches, _ = cs.phase_family(torch, np, "cpu", cfg, params, "11c",
                                  **traffic)
    assert launches["spec_verify_attention"] == 0  # plain versions here
    cfg, params = _small("mixtral-8x7b")
    cs.phase_family(torch, np, "cpu", cfg, params, "11e", **traffic)
    spy = cs.MoeSpy()
    cs.continuous_layouts(torch, np, cfg, params, "cpu", "cpu", slots=2,
                          n_problems=2, n_requests=4, limits=(8, 16),
                          prompt_len=(6, 12), layouts=("chunked",),
                          lockstep=False, spies=(spy,))
    spy.check(torch, "cpu", cfg, "11e continuous")
    cfg, params = _small("qwen2-vl-2b", mrope_sections=(2, 3, 3))
    cs.phase_vlm(torch, np, "cpu", cfg, params, dev="cpu", B=2, S=64)


def test_moe_replay_catches_a_wrong_slot():
    """A kept MoE call whose slots are not the plain computation's stops
    the run; its own routing passes."""
    from repro_torch.models import layers as L

    cs = _chip_smoke()
    cfg, params = _small("mixtral-8x7b", capacity_factor=0.5)
    moe = params.layers[0].moe
    spy = cs.MoeSpy()
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 9, cfg.d_model)).astype(np.float32))
    with spy:
        for _ in range(2):
            spy.new_epoch()
            L.apply_moe(moe, x, cfg)
    assert L.apply_moe is spy.real
    assert int(spy.dropped) > 0  # the capacity binds
    kept = list(spy.kept)
    spy.check(torch, "cpu", cfg, "ok")
    p, x_, y, gi, slot, keep = kept[0]
    spy.kept = [(p, x_, y, gi, slot.flip(0), keep)] * 2
    with pytest.raises(SystemExit):
        spy.check(torch, "cpu", cfg, "mutated")


def test_greedy_shortfalls_and_first_divergence():
    """The witness's arithmetic: the top token falls 0 short, another
    token by the logit gap; a divergence names the position and both
    shortfalls."""
    cs = _chip_smoke()
    cfg, params = _small_qwen3()
    prompt = [5, 6, 7, 8]
    sf, gap = cs.greedy_shortfalls(torch, cfg, params, prompt, [9, 10, 11])
    assert sf.shape == gap.shape == (3,) and (sf >= 0).all()
    assert (gap >= 0).all()
    res = (np.array([0.0, 0.5]), np.array([0.1, 0.2]))
    ref = (np.array([0.0, 0.0]), np.array([0.1, 0.3]))
    assert cs.first_divergence([1, 2], [1, 2], res, ref, "r0") is None
    d = cs.first_divergence([1, 3], [1, 2], res, ref, "r0")
    assert d == "r0@1: 0.5000/0.0000 (top-2 gap 0.3000)"
    assert cs.first_divergence([1], [1, 2], res, ref, "r1") == \
        "r1: length 1 vs 2"


def test_cli_commands_run_concurrently_and_none_outlives_the_phase():
    """Phase 6's CLIs start at once: each command's exit code, output
    tail and time come back in order, and a command past the time limit
    is killed."""
    import os
    import sys

    cs = _chip_smoke()
    py = sys.executable
    res = cs.run_concurrently(
        [[py, "-c", "print('a'); print('b')"],
         [py, "-c", "import sys; print('x'); sys.exit(3)"]],
        dict(os.environ))
    assert [(rc, tail) for rc, tail, _ in res] == [(0, ["a", "b"]),
                                                   (3, ["x"])]
    (rc, _, t), = cs.run_concurrently(
        [[py, "-c", "import time; time.sleep(30)"]], dict(os.environ),
        timeout_s=0.5)
    assert rc != 0 and t < 10


def test_phase12_xlstm_and_seamless_on_cpu():
    """Phase 12 at small widths on the CPU: 12a's lock-step and
    continuous runs of xLSTM (epoch identity, drafts accepted, every
    token plain greedy's by one batched full-sequence forward, one
    verify forward's op count), 12b's float32 rerun on a cut depth (the
    argmax witness, and staged states gathered at n_commit equal to
    ``commit_upto``'s committed carry bit for bit), and 12c's
    encoder-decoder decode through the ring and the cross cache against
    its full forward, then cut and in float32."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import model as M

    cs = _chip_smoke()
    traffic = dict(dev="cpu", limits=(6, 10), prompt_len=(5, 9))
    cfg = smoke_variant(get_config("xlstm-125m")).replace(
        num_layers=3, d_model=32, rnn_width=32)
    params = M.init_params(cfg, seed=0, device="cpu")
    launches = cs.phase_xlstm(torch, np, "cpu", cfg, params, slots=2,
                              n_problems=2, n_requests=4, **traffic)
    assert launches["spec_verify_attention"] == 0
    cfg = cs.cut_depth(torch, params, cfg, 2)
    assert [b.kind for b in params.layers] == ["mlstm", "slstm"]
    cs.phase_xlstm_f32(torch, np, "cpu", cfg, params, **traffic)
    cfg = smoke_variant(get_config("seamless-m4t-medium")).replace(
        d_model=32, num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64)
    params = M.init_params(cfg, seed=0, device="cpu")
    out = cs.phase_seamless(torch, np, "cpu", cfg, params, dev="cpu", B=2,
                            S_enc=8, prompt=3, steps=4, f32_layers=1)
    assert sorted(out) == ["bf16", "float32"]
    assert params.cfg.num_layers == len(params.encoder) == 1


def test_phase13_workloads_on_cpu():
    """Phase 13 at small widths on the CPU: 13a's decode_32k and verify_8
    steps on the workloads' 33,024-slot ring (every slot valid, lengths
    32,768; the verify step against ``verify_block`` on its logits, rows
    drafting the model's own token accepting), and 13b/13c's GRPO steps
    of xLSTM and the encoder-decoder (the loss at ratio 1, every gradient
    finite and non-zero, every parameter moved), each beside the dry
    run's count of the same small config."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cs = _chip_smoke()
    cfg = get_config("qwen3-8b").replace(
        num_layers=2, d_model=32, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=64, vocab_size=300, vocab_pad_multiple=64)
    params = M.init_params(cfg, seed=0, device="cpu")
    launches = cs.phase_verify_economics(torch, np, "cpu", cfg, params, None,
                                         dev="cpu", reps=1)
    assert launches["spec_verify_attention"] == 0  # plain versions on CPU
    xlstm = get_config("xlstm-125m").replace(
        num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, rnn_width=32,
        vocab_size=300, vocab_pad_multiple=64)
    t, _, rec = cs.phase_grpo_card(torch, np, "cpu", "xlstm-125m", 4, 24,
                                   "13b", dev="cpu", cfg=xlstm)
    assert t > 0 and rec["shape"] == "train_4k" and rec["mesh"] == "1x1"
    encdec = get_config("seamless-m4t-medium").replace(
        num_layers=2, num_encoder_layers=2, d_model=32, num_heads=2,
        num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=300,
        vocab_pad_multiple=64)
    cs.phase_grpo_card(torch, np, "cpu", "seamless-m4t-medium", 2, 16, "13c",
                       dev="cpu", cfg=encdec)


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the port's side: beside the suite's other
    workers a thread a core waits in every parallel region on threads
    that are off the CPU (phase 14's rehearsal took 135 s instead of 8 s
    beside eight busy processes on 8 cores), and these tiny models gain
    nothing from more. ``tests/test_torch_examples.py`` and
    ``tests/test_torch_engine.py`` import it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_phase14_rl_examples_on_cpu(one_torch_thread):
    """Phase 14 at rl_math's tiny preset on the CPU: 14a's three arms at
    T 0 (plain, the example's DAS, DAS drafting through the device path)
    token-identical with equal rewards, losses and grad norms and fewer
    DAS forwards, the SFT CE falling and some rollout ending in EOS; 14b
    at T 0.6 from the same SFT weights with a non-zero grad norm in each
    arm; 14c rl_code's twin of 14a. No launch on the CPU. The tiny
    preset ends rows in EOS after the example's own 10 SFT steps (more
    make its T 0.6 samples equal within each group: zero advantages)."""
    cs = _chip_smoke()
    launches, entries = cs.phase_rl_examples(
        torch, np, "cpu", dev="cpu", preset="tiny",
        steps={"14a": 3, "14b": 2, "14c": 3}, sft=10, max_new=16)
    assert entries == [] and sum(launches.values()) == 0
    assert set(launches) == {"suffix_match_propose",
                             "spec_verify_attention_rl100m_f32",
                             "spec_verify_attention_rlcode_f32"}
