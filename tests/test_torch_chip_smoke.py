"""Host-side helpers of ``chip_smoke.py``, on the CPU.

The suffix-match bound counts the forest entries a per-row walk of the
kernels' row core reads (``walk_needed_reads``); the walk must compute
the same outputs as the plain version, or the count would not be of the
kernel's work. Integers only: bit-identical.
"""

import importlib.util
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
