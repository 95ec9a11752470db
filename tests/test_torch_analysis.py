"""The port's counted cost (``launch.analysis.count_cost``) and the dry
run's extrapolations, exact, on meta tensors at small widths (nothing is
allocated, nothing launched):

* one matmul counts 2·m·n·k FLOPs and the bytes of A, B and C; a view
  counts nothing, an indexed write only the region it writes;
* a dense decoder's forward counts 2 · (matmul parameters) · tokens plus
  the attention's 4·B·T·S·Hq·hd in each layer;
* a spec-verify call and a scan call (forward and, through autograd, the
  backward) inside the mode count their kernels' ``work`` and none of
  their plain versions' operations;
* the layer extrapolation (u and 2u layers, and 2 → 4 encoder layers)
  equals the direct count of FLOPs, bytes and the peak, for an xLSTM
  stack's train and prefill steps too (their recurrences are kernels
  that report their ``work``, at a T that is no multiple of their
  checkpoint interval);
* the dry run's record, the hill-climb's pair C, and the CLIs that print
  a record on a machine without a card.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.kernels.rglru import ops as rg_ops
from repro_torch.kernels.spec_verify import ops as sv_ops
from repro_torch.launch import dryrun as D
from repro_torch.launch import hillclimb as H
from repro_torch.launch import workloads as W
from repro_torch.launch.analysis import Roofline, count_cost
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, make_local_mesh
from repro_torch.models import model as M

ROOT = Path(__file__).resolve().parents[1]


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_matmul_view_and_indexed_write():
    a, b = meta(6, 5, dtype=torch.bfloat16), meta(5, 7, dtype=torch.bfloat16)
    out, c = count_cost(torch.matmul, a, b)
    assert out.shape == (6, 7) and out.is_meta
    assert c.flops == 2 * 6 * 7 * 5
    assert c.bytes == 2 * (6 * 5 + 5 * 7 + 6 * 7)
    assert c.temp_bytes == 2 * 6 * 7
    _, c = count_cost(lambda x: x.view(30).t().reshape(5, 6), a)
    assert (c.flops, c.bytes) == (0, 0)
    cache = meta(4, 64, 3)
    idx = torch.zeros((4, 2), dtype=torch.long, device="meta")
    rows = torch.arange(4, device="meta")[:, None]

    def write(cache, v):
        cache[rows, idx] = v

    _, c = count_cost(write, cache, meta(4, 2, 3))
    # the indices (2 x 32 B + 64 B) and values read, 4·2·3 floats written
    assert c.bytes == (4 * 8 + 4 * 2 * 8) + 4 * 2 * 3 * 4 * 2


def test_dense_forward_counts_matmuls_and_attention():
    cfg = smoke_variant(get_config("qwen3-8b")).replace(num_layers=3)
    params = M.init_params(cfg, device="meta")
    B, T = 2, 24
    tokens = torch.zeros((B, T), dtype=torch.int32, device="meta")
    (logits, _), c = count_cost(M.forward, params, cfg, tokens)
    assert logits.shape == (B, T, cfg.padded_vocab)
    mm = sum(p.numel() for blk in params.layers for part in blk.parts
             if part in ("attn", "mlp") for p in getattr(blk, part).values()
             if p.dim() >= 2)
    mm += params.embed.numel()  # the tied head
    attn = 4 * B * T * T * cfg.num_heads * cfg.head_dim * cfg.num_layers
    assert c.flops == 2 * mm * B * T + attn
    assert not c.launches


def test_kernel_calls_count_their_work_not_their_plain_versions():
    B, T, Hq, Hkv, S1, hd = 3, 9, 8, 2, 257, 64
    q = meta(B, T, Hq, hd, dtype=torch.bfloat16)
    kv = meta(B, S1, Hkv, hd, dtype=torch.bfloat16)
    cpos = torch.empty((B, S1), dtype=torch.int32, device="meta")
    pos = torch.empty((B, T), dtype=torch.int32, device="meta")
    out, c = count_cost(sv_ops.spec_verify_attention, q, kv, kv, cpos, pos)
    assert out.shape == q.shape and out.dtype == q.dtype
    flops, nbytes = sv_ops.work(B, T, Hq, Hkv, S1, hd, 2)
    assert (c.flops, c.bytes, dict(c.launches)) == (
        flops, nbytes, {"spec_verify_attention": 1})
    assert flops == 4 * B * T * S1 * Hq * hd
    assert c.ops == 1  # the output's allocation alone
    # the scan, forward and backward through autograd
    Bs, Ts, Ws = 2, 40, 48
    x, r, i = (meta(Bs, Ts, Ws).requires_grad_() for _ in range(3))
    lam, h0 = meta(Ws).requires_grad_(), meta(Bs, Ws).requires_grad_()

    def fwd_bwd():
        hs, hf = rg_ops.rglru_scan(x, r, i, lam, h0)
        return torch.autograd.grad((hs.sum(), hf.sum()), (x, r, i, lam, h0))

    grads, c = count_cost(fwd_bwd)
    assert [g.shape for g in grads] == [t.shape for t in (x, r, i, lam, h0)]
    assert dict(c.launches) == {"rglru_scan": 1, "rglru_scan_bwd": 1}
    assert c.kernel_flops["rglru_scan"] == 13 * Bs * Ts * Ws
    assert c.kernel_flops["rglru_scan_bwd"] == 25 * Bs * Ts * Ws
    assert c.kernel_bytes["rglru_scan"] == rg_ops.work(Bs, Ts, Ws, False)[1]
    assert c.kernel_bytes["rglru_scan_bwd"] == rg_ops.bwd_work(
        Bs, Ts, Ws, False)[1]
    # the rest is the sums, their seeds' fills and the gradient plumbing:
    # no float32 operation of the plain scan is counted
    assert c.flops == c.kernel_flops["rglru_scan"] \
        + c.kernel_flops["rglru_scan_bwd"]


SMALL = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
             vocab_size=96, vocab_pad_multiple=32)
EXTRAPOLATED = {
    "qwen2": ("qwen2-1.5b", SMALL, 4),
    "hybrid": ("recurrentgemma-9b", dict(SMALL, num_kv_heads=1,
                                         rnn_width=64), 9),
    "encdec": ("seamless-m4t-medium", dict(SMALL, num_encoder_layers=6), 3),
}


@pytest.mark.parametrize("family", list(EXTRAPOLATED))
@pytest.mark.parametrize("kind", ["train", "prefill", "verify"])
def test_layer_extrapolation_equals_the_direct_count(family, kind):
    arch, over, layers = EXTRAPOLATED[family]
    cfg = smoke_variant(get_config(arch)).replace(num_layers=layers, **over)
    shape = W.InputShape({"train": "train_4k", "prefill": "prefill_32k",
                          "verify": "verify_8"}[kind], 32, 2, kind)
    direct, dl = D.count_direct(cfg, shape)
    got, gl = D.counted_cost(cfg, shape)
    # flops, bytes and the peak of live intermediates (temp bytes)
    np.testing.assert_allclose(got, direct, rtol=1e-12)
    assert gl == dl


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_xlstm_extrapolation_in_t_equals_the_direct_count(kind):
    # the xLSTM stack is counted like every other family, in the layers
    # only, at its full T
    cfg = smoke_variant(get_config("xlstm-125m")).replace(
        num_layers=6, **dict(SMALL, d_ff=0, rnn_width=64))
    shape = W.InputShape("train_4k" if kind == "train" else "prefill_32k",
                         150, 2, kind)
    direct, dl = D.count_direct(cfg, shape)
    got, gl = D.counted_cost(cfg, shape)
    # flops, bytes and the peak of live intermediates (temp bytes)
    np.testing.assert_allclose(got, direct, rtol=1e-12)
    assert gl == dl and gl["mlstm_scan"] > 0 and gl["slstm_scan"] > 0


def test_dry_run_record_and_pair_c_on_the_local_mesh():
    cfg = smoke_variant(get_config("qwen3-8b"))
    shape = W.InputShape("verify_8", 64, 2, "verify")
    rec = D.dry_run_one("qwen3-8b", "verify_8", cfg_override=cfg,
                        mesh=make_local_mesh(), shape=shape, verbose=False)
    assert rec["status"] == "ok" and rec["mesh"] == "1x1"
    assert rec["kernel_launches"] == {"spec_verify_attention":
                                      cfg.num_layers}
    assert rec["t_memory_s"] == rec["hlo_bytes"] / HBM_BW
    assert rec["t_compute_s"] == rec["hlo_flops"] / PEAK_FLOPS_BF16
    assert rec["collective_bytes"] is None and rec["t_collective_s"] is None
    state = D.state_bytes(cfg, shape, make_local_mesh())
    assert rec["bytes_per_device"] == state
    assert rec["peak_memory"] == state + rec["temp_bytes"]
    params = sum(t.numel() * t.element_size()
                 for t in M.init_params(cfg, device="meta").parameters())
    cache = W.cache_specs(cfg, shape, make_local_mesh())[0]
    ring = sum(t.numel() * t.element_size() for e in cache.layers
               for t in e) + cache.lengths.numel() * 4
    assert state == params + ring
    rl = Roofline("a", "s", "1x1", 1, 10.0, 5e12, 2.0)
    assert rl.dominant == "memory" and rl.useful_flops_ratio == 0.2
    assert H.step_time(rec) == max(rec["t_compute_s"], rec["t_memory_s"])


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", *args], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_dryrun_and_hillclimb_clis(tmp_path):
    proc = _cli("repro_torch.launch.dryrun", "--arch", "qwen3-8b",
                "--shape", "long_500k", "--both-meshes", "--out",
                str(tmp_path / "d.json"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    recs = json.loads((tmp_path / "d.json").read_text())
    assert [r["status"] for r in recs] == ["skipped", "skipped"]
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    proc = _cli("repro_torch.launch.hillclimb", "--pair", "C", "--out",
                str(tmp_path / "h.json"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    (c,) = json.loads((tmp_path / "h.json").read_text())
    assert c["pair"] == "C" and 0.9 < c["cost_ratio"] < 1.2
    assert c["verify"]["kernel_launches"] == {"spec_verify_attention": 36}
    assert json.loads(proc.stdout.splitlines()[0])["pairs"] == ["C"]
    assert math.isclose(c["verify"]["total_flops"],
                        c["verify"]["hlo_flops"] * 256)
