"""Host-side helpers of ``chip_smoke.py``, on the CPU.

The suffix-match bound counts the forest entries a per-row walk of the
kernels' row core reads (``walk_needed_reads``); the walk must compute
the same outputs as the plain version, or the count would not be of the
kernel's work. Integers only: bit-identical. The RG-LRU scan's bound
counts the bytes of the steps its mask updates, counted here by hand;
its launches split by shape into the JSON line's entries. The scan's
backward bound counts x, r, i and h_{t-1} at the updated steps and the
rest at every step.
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
