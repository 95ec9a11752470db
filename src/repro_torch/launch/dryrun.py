"""Dry run of the port: count every (arch × shape × mesh) at its full
config, allocating nothing (counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each step on 512 placeholder TPU
devices and reads XLA's cost and memory analyses. Here each step runs on
meta tensors (shapes and dtypes, no storage, nothing launched) under
``analysis.count_cost``, and the mesh is abstract (``launch.mesh``), so
the dry run runs on any machine, with or without a card, and touches no
device.

  * ``bytes_per_device`` is exact: each parameter, optimizer-state and
    cache leaf's share under ``sharding.spec_for`` over the mesh, as the
    reference's arithmetic takes it;
  * FLOPs and bytes accessed are the step's totals; the per-device
    figures (``hlo_flops``, ``hlo_bytes``) are total ÷ devices, an ideal
    split: the port does not model XLA's replication;
  * ``peak_memory`` is ``bytes_per_device + temp_bytes / devices``
    (``peak_memory_exact`` False where the peak was extended in T, below);
  * the roofline terms use the NVIDIA H100's published peaks
    (``launch.mesh``); the port counts no collectives (``analysis``).

With ``extrapolate`` (the default) a step is counted at u and 2u layers
(u = the block pattern's length) and extended linearly to the full
depth, as the reference does (an encoder-decoder adds a 2 → 4 encoder
layer pair); the counts are exact for homogeneous stacks. The xLSTM
blocks step T in Python, so counting a 32k prefill op by op would take
tens of minutes: for a config with such blocks, a train or prefill step's
per-layer cost is counted at three short lengths (``T_POINTS``) and
extended in T along the polynomial through them (a train step's bytes
grow as T², see there), beside a zero-layer count at the full length
(the embedding, head and optimizer). A peak is no sum of per-layer
parts: it is counted at u and 2u layers at two lengths (``T_PEAK_POINTS``,
by kind) and extended linearly in the layers, then in T. A
train step's peak is the larger of its loss and gradients' (extended so)
and its AdamW update's, which holds no T-sized tensor; the whole step
counted at the shortest length is no lower than the second. The extension
is exact only while no other moment of the step takes the peak over at a
longer T, so such a record's ``peak_memory_exact`` is False.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape train_4k [--multi-pod] [--all] [--out report.json] [--direct]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import logging
import math
import time
import traceback
from typing import Optional, Tuple

import numpy as np

from repro_torch.configs import ASSIGNED, active_params, get_config
from repro_torch.launch import sharding as sh
from repro_torch.launch import workloads as W
from repro_torch.launch.analysis import Roofline, count_cost, model_flops_for
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.rl import grpo

log = logging.getLogger("repro_torch.launch.dryrun")

# the blocks whose forward steps T in Python, and the lengths their
# per-layer cost is counted at: the backward of a step's slice of a
# (T, ...) tensor writes a zero-filled (T, ...) gradient, so a train
# step's bytes grow as T², and three points fit the quadratic exactly
LOOPED = ("mlstm", "slstm")
T_POINTS = (8, 16, 24)
# the lengths the peak is counted at, by kind, held to ``--direct``
# counts: xLSTM-125M's prefill peak is set by the loop's state
# temporaries at short T, and from T 256, 512 the extension gives
# prefill_32k's direct count exactly; its train step's gradient phase
# from 32, 40 comes within 1% of train_4k's (from 256, 512 it overshoots)
T_PEAK_POINTS = {"train": (32, 40), "prefill": (256, 512)}


def extended_in_t(cfg, shape: W.InputShape) -> bool:
    """Whether ``counted_cost`` extends this step's count in T."""
    return (any(k in LOOPED for k in cfg.layer_kinds)
            and shape.kind in T_PEAK_POINTS
            and shape.seq_len > T_PEAK_POINTS[shape.kind][-1])


def _lagrange(ts, values, t):
    """The polynomial through (ts[i], values[i]) evaluated at t."""
    out = 0.0
    for i, (ti, vi) in enumerate(zip(ts, values)):
        w = 1.0
        for j, tj in enumerate(ts):
            if j != i:
                w *= (t - tj) / (ti - tj)
        out = out + w * vi
    return out


def bytes_per_device(struct_tree, axes_tree, mesh, rules=None) -> float:
    """Bytes one device holds of a (meta tensors, logical axes) tree:
    each leaf's element count divided by the mesh axes its spec shards
    it over, dimension by dimension, as the reference's
    ``_bytes_per_device`` divides."""
    total = 0.0

    def one(t, axes):
        nonlocal total
        n = math.prod(t.shape)
        for ax in sh.spec_for(tuple(t.shape), axes, mesh, rules):
            if ax is None:
                continue
            for a in (ax,) if isinstance(ax, str) else ax:
                n //= mesh.shape[a]
        total += n * t.element_size()

    sh.map_tree(one, struct_tree, axes_tree)
    return total


def state_bytes(cfg, shape: W.InputShape, mesh, rules=None) -> float:
    """The step's resident state a device: parameters, and the AdamW
    moments for train or the cache for decode/verify."""
    total = bytes_per_device(*W.param_specs(cfg), mesh, rules)
    if shape.kind == "train":
        total += bytes_per_device(*W.opt_specs(cfg), mesh, rules)
    elif shape.kind in ("decode", "verify"):
        total += bytes_per_device(*W.cache_specs(cfg, shape, mesh), mesh,
                                  rules)
    return total


def workload(cfg, shape: W.InputShape, use_cross_cache: bool = False):
    """(step function, its meta arguments) of one workload. With
    ``use_cross_cache`` a decode step reads the encoder's projected K/V
    (``build_cross_cache``, an input here as in the reference's pair A)
    in place of ``enc_out``."""
    params = M.init_params(cfg, device="meta")
    inputs, _ = W.input_specs(cfg, shape)
    if shape.kind == "train":
        M.set_trainable(params)
        return W.make_train_fn(cfg), (params, adamw.init_state(params),
                                      inputs)
    if shape.kind == "prefill":
        return W.make_prefill_fn(cfg, shape), (params, inputs)
    cache, _ = W.cache_specs(cfg, shape, make_local_mesh())
    if use_cross_cache:
        inputs["cross_cache"] = M.build_cross_cache(params, cfg,
                                                    inputs.pop("enc_out"))
    return (W.make_decode_fn(cfg, shape, use_cross_cache),
            (params, cache, inputs))


@functools.lru_cache(maxsize=None)
def grads_peak(cfg, shape: W.InputShape) -> float:
    """Peak temp bytes of a train step's GRPO loss and gradients alone
    (``grpo.make_train_step``'s first half, without the AdamW update)."""
    params = M.init_params(cfg, device="meta")
    M.set_trainable(params)
    inputs, _ = W.input_specs(cfg, shape)

    def loss_and_grads():
        loss, _ = grpo.grpo_loss(params, cfg, W.GRPO, inputs)
        return grpo.param_grads(params, loss)

    _, cost = count_cost(loss_and_grads)
    return cost.temp_bytes


@functools.lru_cache(maxsize=None)
def count_direct(cfg, shape: W.InputShape, use_cross_cache: bool = False
                 ) -> Tuple[np.ndarray, dict]:
    """([flops, bytes, temp bytes], kernel launches) of one step counted
    op by op at ``cfg``'s depth. Counts do not depend on the mesh nor the
    rules, so each is kept for the process (``--both-meshes``, the
    hill-climb's rule sets and the extrapolations' short counts reuse
    them)."""
    fn, args = workload(cfg, shape, use_cross_cache)
    _, cost = count_cost(fn, *args)
    return np.array(cost.vector()), dict(cost.launches)


def counted_cost(cfg, shape: W.InputShape, *, extrapolate: bool = True,
                 use_cross_cache: bool = False
                 ) -> Tuple[np.ndarray, dict]:
    """([flops, bytes, temp bytes], kernel launches) of one step at the
    full config: counted directly, or (``extrapolate``) from short counts
    extended linearly in the layers and, for the xLSTM blocks' train and
    prefill steps, in T (see the module docstring). The kernels' launches
    are extended in the layers as the rest (exact for a stack of whole
    block-pattern units; no launch depends on T)."""
    if not extrapolate:
        return count_direct(cfg, shape, use_cross_cache)
    u = max(1, len(cfg.block_pattern))
    L = cfg.num_layers
    enc = {"num_encoder_layers": 2} if cfg.is_encoder_decoder else {}

    def at(layers, s=shape):
        return count_direct(cfg.replace(num_layers=layers, **enc), s,
                            use_cross_cache)

    def in_layers(c_a, c_b, a, b):
        (m_a, l_a), (m_b, l_b) = c_a, c_b
        return (_lagrange((a, b), (m_a, m_b), L),
                {k: round(_lagrange((a, b), (l_a.get(k, 0), l_b.get(k, 0)),
                                    L)) for k in {**l_a, **l_b}})

    if extended_in_t(cfg, shape):
        # per layer at each short T, beside the zero-layer count at full T
        shorts = [dataclasses.replace(shape, seq_len=t) for t in T_POINTS]
        per = [(at(u, s)[0] - at(0, s)[0]) / u for s in shorts]
        base, _ = at(0)
        total = base + L * _lagrange(T_POINTS, per, shape.seq_len)
        # the peak at u and 2u layers and two lengths, extended in the
        # layers, then in T; a train step's no lower than the whole step's
        # at the shortest point, where its AdamW update's peak shows
        if shape.kind == "train":
            def peak(layers, s):
                return grads_peak(cfg.replace(num_layers=layers, **enc), s)
            update = at(L, shorts[0])[0][2]
        else:
            def peak(layers, s):
                return at(layers, s)[0][2]
            update = 0.0
        points = T_PEAK_POINTS[shape.kind]
        longs = [dataclasses.replace(shape, seq_len=t) for t in points]
        peaks = [_lagrange((u, 2 * u), (peak(u, s), peak(2 * u, s)), L)
                 for s in longs]
        total[2] = max(_lagrange(points, peaks, shape.seq_len), update)
        _, launches = in_layers(at(0, shorts[0]), at(u, shorts[0]), 0, u)
        return np.maximum(total, 0.0), launches
    m1 = at(u)
    total, launches = in_layers(m1, at(2 * u), u, 2 * u)
    if cfg.is_encoder_decoder:
        m3, _ = count_direct(cfg.replace(num_layers=u, num_encoder_layers=4),
                             shape, use_cross_cache)
        total = total + (cfg.num_encoder_layers - 2) / 2.0 * (m3 - m1[0])
    return np.maximum(total, 0.0), launches


def dry_run_one(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    rules=None,
    verbose: bool = True,
    extrapolate: bool = True,
    cfg_override=None,
    mesh=None,
    shape: Optional[W.InputShape] = None,
    use_cross_cache: bool = False,
):
    """Count one (arch, shape, mesh); returns the reference's record.
    ``mesh`` replaces the production mesh (``make_local_mesh()``: the one
    card) and ``shape`` the named shape (another batch: a device's
    share)."""
    cfg = cfg_override or get_config(arch)
    shape = shape or W.SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh.name}
    reason = W.skip_reason(cfg, shape)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    rules = rules or sh.DEFAULT_RULES
    n_chips = mesh.size
    t0 = time.perf_counter()
    static = state_bytes(cfg, shape, mesh, rules)
    (flops, nbytes, temp), launches = counted_cost(
        cfg, shape, extrapolate=extrapolate, use_cross_cache=use_cross_cache)
    rl = Roofline(
        arch=arch, shape=shape_name, mesh=rec["mesh"], n_chips=n_chips,
        hlo_flops=float(flops) / n_chips, hlo_bytes=float(nbytes) / n_chips,
        model_flops=model_flops_for(cfg, shape, active_params(cfg))
        / n_chips,
        bytes_per_device=static,
        peak_memory=static + float(temp) / n_chips,
        temp_bytes=float(temp),
    )
    rec.update(rl.as_dict())
    rec["status"] = "ok"
    rec["kernel_launches"] = launches
    rec["peak_memory_exact"] = not (extrapolate and extended_in_t(cfg, shape))
    rec["count_s"] = time.perf_counter() - t0
    if verbose:
        log.info(
            "%-24s %-12s %-8s OK %6.1fs  flops=%.3e bytes=%.3e (totals) "
            "static=%.2fGB peak=%.2fGB dominant=%s useful=%.2f",
            arch, shape_name, rec["mesh"], rec["count_s"], flops, nbytes,
            static / 1e9, rl.peak_memory / 1e9, rl.dominant,
            rl.useful_flops_ratio,
        )
    return rec


def main() -> None:
    if not logging.getLogger().handlers:
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(name)s %(levelname)s %(message)s",
        )
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="all arch × shape")
    ap.add_argument("--out", default="")
    ap.add_argument("--shapes",
                    default="train_4k,prefill_32k,decode_32k,long_500k")
    ap.add_argument("--direct", action="store_true",
                    help="count op by op at full depth and length, no "
                         "extrapolation (what the extrapolations are "
                         "held to; xLSTM's long steps take tens of "
                         "minutes)")
    args = ap.parse_args()

    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = (
        args.shapes.split(",") if (args.all or not args.shape)
        else [args.shape]
    )
    meshes = ([False, True] if (args.both_meshes or args.all)
              else [args.multi_pod])
    t0 = time.perf_counter()
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    rec = dry_run_one(arch, shape, multi_pod=mp,
                                      extrapolate=not args.direct)
                except Exception as e:  # dascheck: disable=DAS303 -- one arch failing must not stop the sweep; recorded as FAILED in the report
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "FAILED", "error": str(e)[:2000]}
                results.append(rec)
                print(json.dumps(rec, default=str), flush=True)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_fail = sum(r["status"] == "FAILED" for r in results)
    print(f"[dryrun] ok={n_ok} skipped={n_skip} FAILED={n_fail} in "
          f"{time.perf_counter() - t0:.1f} s (counted on meta tensors)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print(f"[dryrun] wrote {args.out}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
