#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`embodied_clip_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # build the kernels, check them, drive the port
    python3 chip_smoke.py --profile  # also print torch.profiler tables of the encodes

Phases:
  1. torch version, device, and `nvidia-smi`'s name and power limit;
  2. build every CUDA source of the port with nvcc (in parallel) and time it; check that
     the SASS of `bottleneck_bf16` (K6/K7) holds wgmma (HGMMA) and no mma.sync (HMMA),
     that of `stem_int8` (K2) bf16 wgmma (HGMMA), that of `bottleneck_int8` (K3-K5)
     s8 wgmma (IGMMA) beside bf16 wgmma (HGMMA: K3's shortcut) and no dp4a (IDP.4A),
     and that of `preprocess` (K1) the 1-D bulk copy (UBLKCP);
  3. hold kernel K1 (fused preprocess) to its plain PyTorch version on the card:
     bit-equal at the main path's shape (golden_frames(128), 300x300 → 224), f32 and
     bf16; ≤1.5 uint8 LSB with <1e-3 of pixels flipped at batches 128, 1 and 5, on a
     frames view at a data_ptr 13 bytes past 16-byte alignment, an upscale and an odd
     width; bf16 output bit-equal to the f32 output cast; time the kernel (bf16 and f32
     out) and the plain version at batches 128 and 1, with the kernel's bound for this
     card and, as a yardstick the port never calls, `interpolate(mode="bicubic",
     antialias=True)` of an f32 NCHW copy of the same frames (the resize alone);
  4. drive the bf16 path: BN-folded `clip_rn50` serving four requests of fresh uint8
     frames (batch 1, 8, 32, 128, NHWC and flat); check keys, shapes, finite values
     and the launches per request (K1 1, K7 1, K6 10); hold the bf16 features to the
     port's unfolded f32 encoder (TF32 off) at ≤1e-3 cosine; time a batch-128 encode
     with the kernels and on the cuDNN route (`fold_bn(fused_bottlenecks=False)`, the
     same weights), in turns;
  5. quantize that encoder (calibrated on golden_frames(32)) and encode
     golden_frames(128) through path A (K2 + K3 + K5) and path B (K2 + K3 + K4),
     recording every kernel call's inputs; hold K2 and K3 to their plain versions at
     ≤1 s8 step on ≤0.5% of elements, K4 and K5 bit-exactly; time each kernel and its
     plain version on those inputs (back-to-back wrapper calls between CUDA events, as
     every kernel's `ms`; beside it `device_ms`, the calls replayed from a CUDA graph,
     which leaves out the host's share), compute its bound, and print each call's
     achieved TOP/s and share of the bound; time K3's entry launch (cb1a and the conv
     shortcut) alone against its bound; beside K2 and that launch, a yardstick timed the
     same way that the port never calls: cuDNN's bf16 conv of the same stem3 shape
     (channels-last, the conv alone) and `torch.matmul` of the shortcut's bf16 product;
  6. drive the int8 main path: the four requests through path A, with launches per
     request K1 1, K2 1, K3 1, K5 3; the same through path B, with K4 12 per request;
     keys, shapes, finite bf16; cosine distance vs the f32 encoder ≤1e-3 for the
     pooled keys and ≤2e-3 for the conv map (`INT8_COSINE_LIMITS`); paths A and B
     bit-identical; batch-128 encode times of both paths;
  7. record every K6/K7 call of a batch-128 `clip_rn50` encode and of an
     `imagenet_rn50` encode; hold each to its plain version (`parity.bf16_disagreement`:
     ≤1% of elements differ, each within two bf16 steps; K7 block by block,
     `parity.stage1_block_disagreements`, its chained output reported); time the
     kernel, the plain version and the same block(s) on the eager cuDNN route, compute
     the bound, and print each call's achieved TFLOP/s and share of the bound;
  8. the ImageNet family: bf16 folded `imagenet_rn50` and `imagenet_rn18` serve the four
     requests (shapes, finite bf16, launches per request: rn50 K1 1, K7 1, K6 10; rn18
     K1 1 and no K6/K7), ≤1e-3 cosine vs their f32 unfolded encoders, batch-128 encode
     times; then `imagenet_rn50.quantize(golden_frames(32))` serves them, held to
     `IMAGENET_INT8_COSINE_LIMITS`, with its encode time;
  9. the DD-PPO training step with the frozen encoder inside the rollout, at the
     example's full width (`clip_rn50`, GridNav size 8 rendering 56×56 frames, 32 envs,
     rollout 64, hidden 512, 4 PPO epochs), in a one-process NCCL group so that the
     gradient all-reduce runs on the card: 5 iterations with the bf16 folded encoder
     (loss finite, weights changed, launches per iteration K1 = K7 = 65, K6 = 650); the
     stored `clip_conv` features of one rollout step within 1e-3 cosine of the f32
     unfolded encoder on the same frames; every K6/K7 call of one rollout encode (batch
     32) held to its plain version with phase 7's contract; K1 at the rollout's shape,
     (32, 56, 56) → 224, held to its plain version and timed; one iteration on int8 path
     A (K1, K2, K3 65, K5 195), its stored features within `INT8_COSINE_LIMITS`, every
     K2/K3/K5 call of one rollout encode held with phase 5's contracts. Iterations 0, 2
     and 3 are split into rollout (encode, env, policy step, the rest) and update (the
     gradient all-reduces within it) by CUDA events and hooks; iterations 1 and 4 carry
     only the iteration's own events, so that the split's cost shows; each iteration's
     host ms in Python's garbage collector; env-steps/s, peak device memory; `--profile`
     adds the device-busy share of one rollout and one update;
 10. the host-simulator path at full width: pools of 8 worker processes (VectorEnv,
     started from its fork server after CUDA is up, frames through the shared-memory
     ring, checked live) of the port's THOR adapters over `tests/fake_thor.py`'s
     scripted controller (the only THOR here; ai2thor is not installed) at 300×300,
     feeding the bf16 folded `clip_rn50` and the allenact policy (hidden 512), the host
     learners' collectives in a one-process NCCL group:
     (a) `HostPPOLearner`, rollout 64, 4 epochs, 3 iterations: loss finite, weights
     changed, launches per iteration K1 = K7 = 65 and K6 = 650, the stored features of
     act step 0 within 1e-3 cosine of the f32 unfolded encoder on the same frames, every
     K6/K7 call of one act-step encode (batch 8) held to its plain version with phase
     7's contract, K1 at the act step's shape (8, 300, 300) → 224 held to its plain
     version and timed, the act / env_step / update split, env-steps/s, the encode's
     share of the act step, peak device memory (`--profile`: the device-busy share of
     one rollout and one update); (c) one iteration on int8 path A (K1, K2, K3 65, K5
     195): the stored features equal to the encoder's output on the same frames, the
     encoder at batch 8 within `INT8_COSINE_LIMITS` on golden_frames(8), the stored
     features' distance to f32 printed beside the plain int8 graph's (the scripted
     controller's flat frames put both far from f32), and held within 1e-3 cosine
     (`INT8_PLAIN_GRAPH_LIMIT`) of the plain int8 graph fed by the same stem (K2) on the
     same frames, the distance to the plain graph with its own stem printed beside it;
     every K2/K3/K5 call of one act-step encode held with phase 5's contracts; (d) a
     worker SIGKILLed at act step 20: respawned, its step and the respawned worker's
     first step masked invalid (the latter done), the update runs; (e)
     `evaluate_policy_host` (deterministic, val scenes) delivers 16 episodes, written by
     `write_metrics_json` and scored by `compute_scores`; (b) 2 pipelined groups of 8 workers, 2 iterations (launches
     doubled), env-steps/s beside (a) and (c); (f) `HostDAggerLearner` on the 1-phase
     `THORRearrangeEnv` (both views encoded: K1 = K7 = 128, K6 = 1280 an iteration of
     64 steps; a 4096-channel map), 2 iterations with the aggregate of 2 rollouts in
     host memory; every pool closed with no worker left, then the fork server and its
     resource tracker stopped (`stop_fork_server`), which would otherwise outlive the
     script; (g) K1 at Habitat's frame shape (8, 480, 640) → 224 held to its plain
     version and timed;
 11. check that no process the script started is left, then print {"kernels": [...]}
     and the last line {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero. It exits non-zero at once, and
prints no result, where no CUDA device is available.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

# Card → (device-memory bytes/s, f32 CUDA-core, dense bf16 and dense int8 tensor-core
# operations/s), NVIDIA data sheets. Matched by substring of the name, most specific
# first.
CARDS = (("H100 PCIe", 2.0e12, 51e12, 756e12, 1513e12),
         ("H100 NVL", 3.9e12, 60e12, 835e12, 1671e12),
         ("H100", 3.35e12, 67e12, 989e12, 1979e12),
         ("H200", 4.8e12, 67e12, 989e12, 1979e12))
REQUESTS = ((1, "nhwc"), (8, "flat"), (32, "nhwc"), (128, "flat"))
LSB_LIMIT, FLIP_LIMIT, COSINE_LIMIT = 1.5, 1e-3, 1e-3
# int8 vs f32 cosine distance per key. The pooled features keep the 1e-3 north star.
# The conv map cannot: on these seed-0 weights the JAX package's own int8 trunk is at
# 1.83e-3 (tests/test_torch_quantize.py::test_rn50_int8_fidelity_matches_jax, which
# holds the port to it on the CPU), so the map is held to that, rounded up.
INT8_COSINE_LIMITS = {"clip_conv": 2e-3, "clip_avgpool": 1e-3, "clip_attnpool": 1e-3}
# The ImageNet int8 path, likewise: on the same seed-0 weights the JAX package's own int8
# imagenet_rn50 is at 1.357e-3 on the conv map and 5.8e-5 on the pooled key
# (tests/test_torch_quantize.py::test_imagenet_rn50_int8_fidelity_matches_jax).
IMAGENET_INT8_COSINE_LIMITS = {"imagenet_conv": 1.5e-3, "imagenet_avgpool": 1e-3}
# int8 path A's features vs the plain int8 graph fed by the same stem (K2) on the same
# frames: the limit at which tests/test_torch_gpu.py holds the int8 paths to the plain graph.
INT8_PLAIN_GRAPH_LIMIT = 1e-3
STEP_LIMIT, STEP_SHARE_LIMIT = 1, 0.005  # K2, K3 vs plain (tests/test_stem_kernel.py:43)
# Launches per request on each int8 path (clip_rn50: 3 identity runs, 12 boundaries).
PER_REQUEST = {"A": {"fused_preprocess": 1, "stem3_requant_pool_int8": 1,
                     "fused_stage1_int8": 1, "fused_resblocks_int8": 3,
                     "fused_cb3_cb1_int8": 0},
               "B": {"fused_preprocess": 1, "stem3_requant_pool_int8": 1,
                     "fused_stage1_int8": 1, "fused_resblocks_int8": 0,
                     "fused_cb3_cb1_int8": 12}}
# Launches per request on the folded bf16 paths (RN50 trunks: stage 1, 3 + 5 + 2
# identity blocks; ResNet-18's basic blocks run no bottleneck kernel).
BF16_PER_REQUEST = {"clip_rn50": {"fused_preprocess": 1, "fused_stage1": 1,
                                  "fused_bottleneck": 10},
                    "imagenet_rn50": {"fused_preprocess": 1, "fused_stage1": 1,
                                      "fused_bottleneck": 10},
                    "imagenet_rn18": {"fused_preprocess": 1, "fused_stage1": 0,
                                      "fused_bottleneck": 0}}
FEATURE_SHAPES = {  # per frame
    "clip_rn50": {"clip_conv": (7, 7, 2048), "clip_avgpool": (2048,),
                  "clip_attnpool": (1024,)},
    "imagenet_rn50": {"imagenet_conv": (7, 7, 2048), "imagenet_avgpool": (2048,)},
    "imagenet_rn18": {"imagenet_conv": (7, 7, 512), "imagenet_avgpool": (512,)}}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def descendants() -> dict:
    """{pid: parent pid} of every process below this one that has not exited, read
    from /proc (zombies, already exited, are left out)."""
    parent = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:  # exited while we looked
            continue
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        if state != "Z":
            parent[int(d)] = int(ppid)
    out, frontier = {}, [os.getpid()]
    while frontier:
        pid = frontier.pop()
        for child, pp in parent.items():
            if pp == pid:
                out[child] = pp
                frontier.append(child)
    return out


def card_rates(name: str):
    for card in CARDS:
        if card[0] in name:
            return card
    print(f"[3] unknown card {name!r}: bounds computed with H100 SXM rates")
    return ("H100 SXM (assumed)",) + CARDS[2][1:]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 10) -> float:
    """Device ms of one fn() call, replayed from a CUDA graph: the host's share of a
    wrapper call (checks, tensor maps, launches) is left out."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(graph.replay, iters)
    del graph
    return ms


def preprocess_work(n: int, in_hw, size: int, out_bytes: int):
    """(bytes, FLOPs) K1 needs for n frames: each input byte read once, each output
    written once; multiply-adds over the resize matrices' nonzeros (the rows the
    height pass reads), plus the normalise."""
    import numpy as np

    from embodied_clip_tpu_torch.ops.resize import resize_plan

    wh, ww = resize_plan(in_hw, size, (size, size))
    rows_needed = int((np.abs(wh).sum(axis=0) > 0).sum())
    flops_frame = (2 * 3 * (rows_needed * np.count_nonzero(ww) + size * np.count_nonzero(wh))
                   + 2 * size * size * 3)
    nbytes = n * (in_hw[0] * in_hw[1] * 3 + size * size * 3 * out_bytes)
    return nbytes, n * flops_frame


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def int8_work(name: str, args, kw, out):
    """(bytes, int8 ops, bf16 ops) one call of kernel `name` needs: each input and
    weight read once (an s8 weight once, not its K-major copy `*_t` beside it), each
    output written once; 2 operations per multiply-add."""
    if name == "stem3_requant_pool_int8":
        x, kernel, bias, _ = args
        n, h, w, cin = x.shape
        cout = kernel.shape[-1]
        return (nbytes(x, out) + 9 * cin * cout * 2 + nbytes(bias),
                0, 2 * n * h * w * 9 * cin * cout)
    if name == "fused_stage1_int8":
        x8, ops = args
        m = x8.numel() // x8.shape[-1]
        macs = sum(ops[f"k{i}{L}"].numel() for i in (1, 2, 3) for L in "abc")
        w = nbytes(*(v for k, v in ops.items() if not k.endswith("_t")))
        return nbytes(x8, out) + w, 2 * m * macs, 2 * m * ops["wsc"].numel()
    if name == "fused_cb3_cb1_int8":
        x8, res8, ops = args
        m = x8.numel() // x8.shape[-1]
        macs = ops["k3"].numel() + ops["k1"].numel()
        w = nbytes(*(v for k, v in ops.items() if not k.endswith("_t")))
        return nbytes(x8, res8, *out) + w, 2 * m * macs, 0
    if name == "fused_resblocks_int8":
        x8, blocks, scl = args
        m = x8.numel() // x8.shape[-1]
        macs = sum(b[k].numel() for b in blocks for k in ("k1", "k2", "k3"))
        w = nbytes(*(v for b in blocks for k, v in b.items() if not k.endswith("_t")), scl)
        return nbytes(x8, out) + w, 2 * m * macs, 0
    raise KeyError(name)


def bf16_work(name: str, args, kw):
    """(bytes, 0, bf16 ops) one K6/K7 call needs: x read once, the output written
    once, each weight and bias read once; 2 operations per multiply-add."""
    x = args[0]
    m = x.numel() // x.shape[-1]
    if name == "fused_bottleneck":
        blocks, extra = [kw], []
    else:
        blocks, extra = args[1], list(args[2])
    weights = [t for b in blocks for t in b.values()] + extra
    macs = sum(b[k].numel() for b in blocks for k in ("w1", "w2", "w3"))
    macs += extra[0].numel() if extra else 0
    out_bytes = m * blocks[-1]["w3"].shape[-1] * x.element_size()
    return nbytes(x, *weights) + out_bytes, 0, 2 * m * macs


def bound(work, card):
    """(bound ms, 'bytes' | 'operations'): the larger of bytes at the memory rate and
    the operations at their type's dense tensor-core peak."""
    b, ops8, ops16 = work
    _, bw, _, bf16, i8 = card
    bytes_ms, ops_ms = b / bw * 1e3, (ops8 / i8 + ops16 / bf16) * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


class Recorder:
    """Stands in for a kernel wrapper in its module: records each call's arguments and
    result and calls through. `launches` reads and writes the wrapper's own count
    (the wrapper increments it through the module's name, which is this object)."""

    def __init__(self, module, name):
        self.module, self.name, self.fn, self.calls = module, name, getattr(module, name), []

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        self.calls.append((args, kw, out))
        return out

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def hold_int8_call(mod, name, args, kw):
    """One recorded K2-K5 call against its plain version on the same inputs: K2 and K3
    within STEP_LIMIT s8 steps on at most STEP_SHARE_LIMIT of the elements, K4 and K5
    bit-exact. Returns (worst step, share of elements that differ)."""
    import torch

    fn, ref = getattr(mod, name), getattr(mod, name + "_reference")
    # K2's `wmat` is the kernel's own copy of its weights, not an input of K2.
    pkw = {k: v for k, v in kw.items() if k != "wmat"}
    before = fn.launches
    got = fn(*args, **kw)
    want = ref(*args, **pkw)
    torch.cuda.synchronize()
    check(fn.launches == before + 1, f"{name} launched its kernel")
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    worst_step, worst_share = 0, 0.0
    for g, w in pairs:
        check(g.shape == w.shape and g.dtype == w.dtype, f"{name} output shape/type")
        d = (g.int() - w.int()).abs()
        step, share = int(d.max()), float((d != 0).float().mean())
        worst_step, worst_share = max(worst_step, step), max(worst_share, share)
        if name in ("stem3_requant_pool_int8", "fused_stage1_int8"):
            check(step <= STEP_LIMIT and share <= STEP_SHARE_LIMIT,
                  f"{name} vs plain: {step} steps on {share:.2e} of elements")
        else:
            check(torch.equal(g, w), f"{name} bit-exact vs its plain version on "
                                     f"{tuple(args[0].shape)}")
    return worst_step, worst_share


def hold_bf16_call(name, args, kw, label):
    """One recorded K6/K7 call against its plain version on the same inputs
    (`parity.bf16_disagreement`; K7 block by block). Returns (kernel output, plain
    output, share differing, worst of the allowance, per-block pairs)."""
    import torch

    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
    from embodied_clip_tpu_torch.parity import (
        BF16_KERNEL_SHARE,
        bf16_disagreement,
        stage1_block_disagreements,
    )

    fn, ref = getattr(BK, name), getattr(BK, name + "_reference")
    before = fn.launches
    got = fn(*args, **kw)
    want = ref(*args, **kw)
    torch.cuda.synchronize()
    check(fn.launches == before + 1, f"{name} launched its kernel")
    check(got.shape == want.shape and got.dtype == want.dtype == torch.bfloat16
          and bool(torch.isfinite(got.float()).all()), f"{name} output")
    share, worst = bf16_disagreement(got, want)
    per_block = (stage1_block_disagreements(*args) if name == "fused_stage1"
                 else [(share, worst)])
    # K7 is held block by block; its chained output is reported (parity.py).
    check(all(s <= BF16_KERNEL_SHARE and w <= 1.0 for s, w in per_block),
          f"{label} {name} {tuple(args[0].shape)} vs plain: {share:.2e} differ, "
          f"worst {worst:.3f}; per block {per_block}")
    return got, want, share, worst, per_block


def check_int8_kernels(qenc, frames, card, profile):
    """Phase 5: every K2–K5 call of a batch-128 encode on paths A and B, against the
    plain version on the same inputs; timings and bounds summed over one encode."""
    import torch

    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
    from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK
    from embodied_clip_tpu_torch.ops.quantize import PATH_B

    kernels = [(SK, "stem3_requant_pool_int8", "A"), (BK, "fused_stage1_int8", "A"),
               (BK, "fused_resblocks_int8", "A"), (BK, "fused_cb3_cb1_int8", "B")]
    recs = {}
    for path, enc in (("A", qenc), ("B", qenc.with_kernels(**PATH_B))):
        with Recorder(SK, "stem3_requant_pool_int8") as r2, \
                Recorder(BK, "fused_stage1_int8") as r3, \
                Recorder(BK, "fused_resblocks_int8") as r5, \
                Recorder(BK, "fused_cb3_cb1_int8") as r4:
            enc.encode(frames)
            torch.cuda.synchronize()
        for r in (r2, r3, r4, r5):
            if r.calls:
                recs.setdefault(r.name, r.calls)
    results = {}
    for mod, name, path in kernels:
        fn, ref = getattr(mod, name), getattr(mod, name + "_reference")
        calls = recs.get(name, [])
        check(len(calls) > 0, f"{name} ran on path {path}")
        worst_step, worst_share = 0, 0.0
        ms = device_ms = plain_ms = bound_ms = 0.0
        by = {"bytes": 0.0, "operations": 0.0}
        for args, kw, out in calls:
            step, share = hold_int8_call(mod, name, args, kw)
            worst_step, worst_share = max(worst_step, step), max(worst_share, share)
            pkw = {k: v for k, v in kw.items() if k != "wmat"}
            k_ms = cuda_ms(lambda: fn(*args, **kw), 10)
            d_ms = graph_ms(lambda: fn(*args, **kw))
            p_ms = cuda_ms(lambda: ref(*args, **pkw), 3, warmup=1)
            work = int8_work(name, args, kw, out)
            b_ms, b_by = bound(work, card)
            ms, device_ms = ms + k_ms, device_ms + d_ms
            plain_ms, bound_ms = plain_ms + p_ms, bound_ms + b_ms
            by[b_by] += b_ms
            tops = (work[1] + work[2]) / k_ms / 1e9
            print(f"[5] {name} {tuple(args[0].shape)}: kernel {k_ms:.4f} ms ({tops:.1f} "
                  f"TOP/s, {b_ms / k_ms:.1%} of the bound; {d_ms:.4f} ms on the device, "
                  f"replayed from a CUDA graph), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"by {b_by}")
        contract = (f"≤{STEP_LIMIT} step on ≤{STEP_SHARE_LIMIT:g}: worst {worst_step} step "
                    f"on {worst_share:.2e}" if name in ("stem3_requant_pool_int8",
                                                        "fused_stage1_int8")
                    else "bit-exact")
        print(f"[5] {name}: {len(calls)} call(s) per batch-128 encode (path {path}): kernel "
              f"{ms:.4f} ms ({device_ms:.4f} ms on the device, from CUDA graphs), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms; {contract}")
        results[name] = {"max_abs_err": float(worst_step), "ms": ms, "device_ms": device_ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": max(by, key=by.get)}
    results["stem3_requant_pool_int8"].update(stem_yardstick(recs))
    results["fused_stage1_int8"].update(stage1_entry(recs, card))
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                qenc.encode(frames)
            torch.cuda.synchronize()
        print("[5] int8 path A, 3 encodes of golden_frames(128), device time by op:")
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30))
    return results


def stem_yardstick(recs):
    """Phase 5: cuDNN's bf16 conv of K2's stem3 shape (channels-last, the conv alone, no
    requant or pool) on the recorded input, timed as K2 is. It does not compute K2's
    function (`library_ms` stays null) and the port never calls it."""
    import torch
    import torch.nn.functional as F

    (x, kernel, _, _), _, _ = recs["stem3_requant_pool_int8"][0]
    xc = x.permute(0, 3, 1, 2)  # the NCHW view of NHWC: channels-last
    wc = kernel.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    ms = cuda_ms(lambda: F.conv2d(xc, wc, padding=1), 10)
    print(f"[5] yardstick beside K2: cuDNN bf16 conv {tuple(x.shape)} → {kernel.shape[-1]} "
          f"channels (channels-last, the conv alone) {ms:.4f} ms")
    return {"yardstick_ms": ms, "yardstick": "cuDNN bf16 3x3 conv, channels-last, alone"}


def stage1_entry(recs, card):
    """Phase 5: K3's entry launch (cb1a and the conv shortcut from one read of x8) on the
    recorded batch-128 input, timed alone against its bound, and the share of shortcut
    elements it flagged as near-ties and summed again exactly; beside it `torch.matmul` of
    the shortcut's bf16 product alone (not the launch's function; the port never calls
    it)."""
    import torch

    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK

    (x8, ops), _, _ = recs["fused_stage1_int8"][0]
    scl = ops["scl"]

    def entry():
        return BK._stage1_entry(x8, ops, BK._ptr(scl, 1), BK._ptr(scl, 0), BK._ptr(scl, 10))

    ms = cuda_ms(entry, 10)
    q1, sc8, ties = entry()
    cin, cout = ops["wsc"].shape
    m = x8.numel() // cin
    bits = torch.tensor([bin(i).count("1") for i in range(256)], device=x8.device)
    flagged = int(bits[ties.view(torch.uint8).long()].sum()) / (m * cout)
    work = (nbytes(x8, q1, sc8, ops["k1a"], ops["s1a"], ops["b1a"], ops["wsc"], ops["bsc"]),
            2 * m * cin * ops["k1a"].shape[-1], 2 * m * cin * cout)
    b_ms, b_by = bound(work, card)
    a16 = (x8.reshape(m, cin).float() * scl[0]).to(torch.bfloat16)
    mm_ms = cuda_ms(lambda: torch.matmul(a16, ops["wsc"]), 10)
    print(f"[5] K3 entry launch {tuple(x8.shape)} → q1 {tuple(q1.shape)}, sc8 "
          f"{tuple(sc8.shape)}: {ms:.4f} ms, {b_ms / ms:.1%} of its bound {b_ms:.4f} ms by "
          f"{b_by}; {flagged:.3e} of sc8 flagged as near-ties and summed again exactly; "
          f"yardstick: torch.matmul of the bf16 shortcut product alone {mm_ms:.4f} ms")
    return {"entry_ms": ms, "entry_bound_ms": b_ms, "entry_flagged": flagged,
            "yardstick_ms": mm_ms,
            "yardstick": "torch.matmul of the bf16 shortcut product, alone"}


def check_bf16_kernels(encoders, frames, card):
    """Phase 7: every K6/K7 call of a batch-128 encode of each encoder in `encoders`
    ({label: folded bf16 encoder}) against its plain version; timings, bounds and the
    cuDNN route's time of the same block(s), summed over one encode."""
    import torch

    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK

    results = {}
    for label, enc in encoders.items():
        with Recorder(BK, "fused_stage1") as r7, Recorder(BK, "fused_bottleneck") as r6:
            enc.encode(frames)
            torch.cuda.synchronize()
        steps = [mod for kind, mod in enc.module.fused_plan() if kind != "module"]
        calls = [("fused_stage1", c) for c in r7.calls] + [("fused_bottleneck", c)
                                                            for c in r6.calls]
        check(len(calls) == len(steps) and len(r7.calls) == 1,
              f"{label}: K6/K7 calls {len(r6.calls)}/{len(r7.calls)} match its plan")
        for (name, (args, kw, out)), mod in zip(calls, steps):
            fn, ref = getattr(BK, name), getattr(BK, name + "_reference")
            got, want, share, worst, per_block = hold_bf16_call(name, args, kw, label)
            xc = args[0].permute(0, 3, 1, 2)  # the NCHW channels-last view the block takes
            k_ms = cuda_ms(lambda: fn(*args, **kw), 10)
            p_ms = cuda_ms(lambda: ref(*args, **kw), 3, warmup=1)
            c_ms = cuda_ms(lambda: mod(xc), 10)
            work = bf16_work(name, args, kw)
            b_ms, b_by = bound(work, card)
            tflops = work[2] / k_ms / 1e9
            r = results.setdefault(name, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                          "cudnn_route_ms": 0.0, "by": {}, "share": 0.0,
                                          "worst": 0.0, "max_abs_err": 0.0, "calls": {}})
            if label == "clip_rn50":  # the row's numbers: one clip_rn50 encode
                for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", b_ms),
                               ("cudnn_route_ms", c_ms)):
                    r[key] += v
                r["by"][b_by] = r["by"].get(b_by, 0.0) + b_ms
            r["calls"].setdefault(label, []).append(
                {"shape": list(args[0].shape), "ms": k_ms, "plain_ms": p_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "tflops": tflops,
                 "share_of_bound": b_ms / k_ms, "cudnn_route_ms": c_ms,
                 "share_differing": share, "worst_of_allowance": worst,
                 **({"per_block": per_block} if name == "fused_stage1" else {})})
            r["share"] = max(r["share"], max(s for s, _ in per_block))
            r["worst"] = max(r["worst"], max(w for _, w in per_block))
            r["max_abs_err"] = max(r["max_abs_err"], float((got.float() - want.float())
                                                           .abs().max()))
            print(f"[7] {label} {name} {tuple(args[0].shape)}: kernel {k_ms:.4f} ms "
                  f"({tflops:.1f} TFLOP/s, {b_ms / k_ms:.1%} of the bound), plain "
                  f"{p_ms:.4f} ms, cuDNN route {c_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}; "
                  f"{share:.2e} of elements differ, worst {worst:.3f} of the allowance"
                  + (f"; per block {[(round(a, 6), round(b, 3)) for a, b in per_block]}"
                     if name == "fused_stage1" else ""))
    for name, r in results.items():
        per_enc = {lab: sum(c["ms"] for c in calls) for lab, calls in r["calls"].items()}
        print(f"[7] {name}: per batch-128 encode (kernel ms) {per_enc}; clip_rn50: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, cuDNN route "
              f"{r['cudnn_route_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")
    return results


class EventSpans:
    """CUDA-event spans around calls: `wrap(fn)` records an event before and after
    each call while `on` is set (otherwise it calls fn alone); `ms()` sums the spans
    since the last `reset()` (it synchronises)."""

    def __init__(self):
        self.spans, self.on = [], True

    def mark(self):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wrap(self, fn):
        def timed(*args, **kw):
            if not self.on:
                return fn(*args, **kw)
            start = self.mark()
            out = fn(*args, **kw)
            self.spans.append((start, self.mark()))
            return out
        return timed

    def reset(self, on=True):
        self.spans, self.on = [], on

    def ms(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.spans)


class TimedEnv:
    """The env with its `step` inside CUDA-event spans."""

    def __init__(self, env, spans: EventSpans):
        self.env, self.step = env, spans.wrap(env.step)

    def __getattr__(self, name):
        return getattr(self.env, name)


class GCTime:
    """Host ms spent in Python's garbage collector while active (`gc.callbacks`)."""

    def __init__(self):
        self.ms, self._t0 = 0.0, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.ms += (time.perf_counter() - self._t0) * 1e3

    def __enter__(self):
        import gc

        self.ms = 0.0
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self)


def hold_rollout_calls(fe, frames, label, phase="9"):
    """Phases 9 and 10: every K2-K7 call of one rollout encode (the rollout's own
    frames: batch-32 56×56 in phase 9, batch-8 300×300 in phase 10) against its plain
    version on the same inputs, with phase 5's and phase 7's contracts. Returns
    {kernel: {calls, worst, share}}."""
    import contextlib

    import torch

    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
    from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK

    per_encode = {"bf16": {"fused_stage1": 1, "fused_bottleneck": 10},
                  "int8": {k: v for k, v in PER_REQUEST["A"].items()
                           if v and k != "fused_preprocess"}}[label]
    modules = {"stem3_requant_pool_int8": SK}
    with torch.inference_mode(), contextlib.ExitStack() as stack:
        recs = [stack.enter_context(Recorder(modules.get(name, BK), name))
                for name in per_encode]
        fe(frames)
        torch.cuda.synchronize()
    held = {}
    with torch.inference_mode():
        for r in recs:
            check(len(r.calls) == per_encode[r.name],
                  f"{label} rollout encode: {len(r.calls)} {r.name} calls, expected "
                  f"{per_encode[r.name]}")
            worst, share = 0.0, 0.0
            for args, kw, _ in r.calls:
                if label == "bf16":
                    _, _, s, w, per_block = hold_bf16_call(r.name, args, kw, label)
                    w, s = max(b for _, b in per_block), max(a for a, _ in per_block)
                else:
                    w, s = hold_int8_call(modules.get(r.name, BK), r.name, args, kw)
                worst, share = max(worst, w), max(share, s)
            contract = ("≤1% of elements differ, each within 2 bf16 steps" if label == "bf16"
                        else f"≤{STEP_LIMIT} step on ≤{STEP_SHARE_LIMIT:g}"
                        if r.name in ("stem3_requant_pool_int8", "fused_stage1_int8")
                        else "bit-exact")
            found = (f"{share:.2e} of elements differ, worst {worst:.3f} of the allowance"
                     if label == "bf16" else f"worst {worst} step(s) on {share:.2e}")
            print(f"[{phase} {label}] {r.name}: {len(r.calls)} call(s) of a rollout encode "
                  f"(input {tuple(r.calls[0][0][0].shape)}) held to the plain version "
                  f"({contract}): {found}")
            held[r.name] = {"calls": len(r.calls), "input_shape": list(r.calls[0][0][0].shape),
                            "worst": worst, "share_differing": share}
    return held


def hold_k1(x, card, smi, tag, what):
    """Phases 9 and 10: K1 on the uint8 frames `x` (on the card) → 224 held to its plain
    version (≤LSB_LIMIT uint8 LSB with <FLIP_LIMIT of pixels flipped, the bf16 output
    equal to the f32 output cast) and timed beside its bound."""
    import torch

    from embodied_clip_tpu_torch import constants
    from embodied_clip_tpu_torch.ops.kernels import preprocess_kernel as K

    mean, std = constants.CLIP_MEAN, constants.CLIP_STD
    lsb = 1.0 / 255.0 / min(std)
    k32 = K.fused_preprocess(x, 224, mean, std, dtype=torch.float32)
    kbf = K.fused_preprocess(x, 224, mean, std, dtype=torch.bfloat16)
    ref = K.fused_preprocess_reference(x, 224, mean, std, dtype=torch.float32)
    err = (k32 - ref).abs()
    flipped = float((err > 0.5 * lsb).float().mean())
    check(float(err.max()) <= LSB_LIMIT * lsb and flipped < FLIP_LIMIT
          and torch.equal(kbf, k32.to(torch.bfloat16)), f"K1 at {what}")
    pp_bytes, flops = preprocess_work(x.shape[0], tuple(x.shape[1:3]), 224, 2)
    bytes_ms, ops_ms = pp_bytes / card[1] * 1e3, flops / card[2] * 1e3
    k1 = {"shape": list(x.shape), "bit_equal": bool(torch.equal(k32, ref)),
          "max_err_lsb": float(err.max()) / lsb, "flipped": flipped,
          "ms": cuda_ms(lambda: K.fused_preprocess(x, 224, mean, std), 200),
          "plain_ms": cuda_ms(lambda: K.fused_preprocess_reference(x, 224, mean, std), 10),
          "bound_ms": max(bytes_ms, ops_ms),
          "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    print(f"[{tag}] K1 at {what} {tuple(x.shape)} → 224 bf16: kernel {k1['ms']:.4f} ms, "
          f"plain {k1['plain_ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms by "
          f"{k1['bound_by']}; max {k1['max_err_lsb']:.4f} LSB, flipped {flipped:.2e}, "
          f"bit-equal to the plain version: {k1['bit_equal']}; {smi}")
    return k1


def check_ddppo(card, smi, profile, turns=1):
    """Phase 9: the DD-PPO step at full width with the frozen encoder in the rollout.
    The bf16 run takes a first iteration, then `turns` times (plain, instrumented,
    instrumented, plain)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from embodied_clip_tpu_torch.envs.gridworld import GridNavEnv
    from embodied_clip_tpu_torch.models.encoders import build_encoder
    from embodied_clip_tpu_torch.models.policy import ActorCritic
    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
    from embodied_clip_tpu_torch.ops.kernels import preprocess_kernel as K
    from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK
    from embodied_clip_tpu_torch.parallel import mesh
    from embodied_clip_tpu_torch.parallel.distributed import initialize_distributed
    from embodied_clip_tpu_torch.parallel.dryrun import free_port
    from embodied_clip_tpu_torch.parity import cosine_distance
    from embodied_clip_tpu_torch.training.ddppo import DDPPOConfig, DDPPOLearner
    from embodied_clip_tpu_torch.training.frames import frozen_encode_fn
    from embodied_clip_tpu_torch.training.ppo import PPOConfig

    check(initialize_distributed(f"localhost:{free_port()}", 1, 0, device="cuda")
          and dist.get_backend() == "nccl", "a one-process NCCL group")
    print(f"[9] torch.distributed: {dist.get_backend()} group of {dist.get_world_size()}; "
          f"TF32 {'on' if torch.backends.cudnn.allow_tf32 else 'off'} for convs, "
          f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'} for matmuls")
    env = GridNavEnv(size=8, max_steps=64, frame_obs=True)
    cfg = DDPPOConfig(rollout_len=64, env_batch=32, ppo=PPOConfig(lr=3e-4, epochs=4))
    encodes = cfg.rollout_len + 1  # one a step, one for the bootstrap value
    counted = {"fused_preprocess": K.fused_preprocess, "fused_stage1": BK.fused_stage1,
               "fused_bottleneck": BK.fused_bottleneck,
               "stem3_requant_pool_int8": SK.stem3_requant_pool_int8,
               "fused_stage1_int8": BK.fused_stage1_int8,
               "fused_resblocks_int8": BK.fused_resblocks_int8,
               "fused_cb3_cb1_int8": BK.fused_cb3_cb1_int8}
    want = {"bf16": {"fused_preprocess": 1, "fused_stage1": 1, "fused_bottleneck": 10},
            "int8": PER_REQUEST["A"]}
    out = {"launches": {}, "iterations": {}, "rollout_calls_held": {}}
    all_sum_ = mesh.all_sum_
    f32 = build_encoder("clip_rn50", dtype=torch.float32, device="cuda")

    def rollout_fidelity(frames, stored, label):
        """The stored features of a rollout step against the f32 unfolded encoder on
        the same frames: bf16 within the north star, int8 within its conv-map limit."""
        limit = COSINE_LIMIT if label == "bf16" else INT8_COSINE_LIMITS["clip_conv"]
        cos = cosine_distance(stored, f32.encode(frames)["clip_conv"])
        print(f"[9 {label}] stored clip_conv of rollout step 0 vs the f32 unfolded encoder "
              f"on the same {tuple(frames.shape)} frames: cosine {cos:.3e} (limit {limit:g})")
        check(cos <= limit, f"{label} rollout features within {limit:g} of f32")
        return cos

    def run(label, int8, instrumented):
        """Iterations of the learner, one for each entry of `instrumented`: with the
        split's CUDA events and hooks (True) or with only the iteration's own (False)."""
        t0 = time.perf_counter()
        fe, is_map = frozen_encode_fn("clip_rn50", torch.bfloat16, int8=int8, device="cuda")
        torch.cuda.synchronize()
        print(f"[9 {label}] frozen encoder built{' and quantized' if int8 else ''} in "
              f"{time.perf_counter() - t0:.2f} s: key {fe.key} {fe.feature_shape}")
        check(is_map and fe.feature_shape == (7, 7, 2048), "clip_rn50 conv map")
        enc_t, env_t, pol_t, red_t = EventSpans(), EventSpans(), EventSpans(), EventSpans()
        policy = ActorCritic(env.num_actions, fe.feature_shape, hidden=512,
                             num_goal_classes=env.num_classes, visual_is_map=is_map)
        policy.register_forward_pre_hook(
            lambda *a: pol_t.spans.append([pol_t.mark()]) if pol_t.on else None)
        policy.register_forward_hook(
            lambda *a: pol_t.spans[-1].append(pol_t.mark()) if pol_t.on else None)
        learner = DDPPOLearner(TimedEnv(env, env_t), policy, cfg,
                               encode_fn=enc_t.wrap(fe), device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        act = learner.init(gen)
        before = [p.detach().clone() for p in policy.parameters()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        rows = []
        for it, on in enumerate(instrumented):
            frames0 = act.obs["visual"].clone()
            for sp in (enc_t, env_t, pol_t, red_t):
                sp.reset(on)
            for fn in counted.values():
                fn.launches = 0  # count this iteration's launches only
            torch.cuda.synchronize()
            with GCTime() as gc_t:
                h0 = time.perf_counter()
                e0 = enc_t.mark()
                rollout, last_value, act, env_m = learner.collect(act, gen)
                e1 = enc_t.mark()
                if on:
                    mesh.all_sum_ = red_t.wrap(all_sum_)  # the gradient all-reduces
                try:
                    metrics = learner.update(rollout, last_value)
                finally:
                    mesh.all_sum_ = all_sum_
                e2 = enc_t.mark()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - h0) * 1e3
            got = {k: fn.launches for k, fn in counted.items()}
            exp = {k: want[label].get(k, 0) * encodes for k in counted}
            check(got == exp, f"{label} launches per iteration {got}, expected {exp}")
            loss = float(metrics["loss"])
            check(np.isfinite(loss), f"{label} loss finite")
            r = {"instrumented": on, "iteration_ms": e0.elapsed_time(e2), "wall_ms": wall,
                 "rollout_ms": e0.elapsed_time(e1), "update_ms": e1.elapsed_time(e2),
                 "gc_ms": gc_t.ms, "loss": loss, "success": float(env_m["success"]),
                 "episodes": float(env_m["episodes"])}
            r["env_steps_per_s"] = cfg.rollout_len * cfg.env_batch / r["iteration_ms"] * 1e3
            split = ""
            if on:
                r.update(encode_ms=enc_t.ms(), env_ms=env_t.ms(), allreduce_ms=red_t.ms(),
                         policy_step_ms=sum(a.elapsed_time(b) for a, b in pol_t.spans))
                r["rollout_rest_ms"] = (r["rollout_ms"] - r["encode_ms"] - r["env_ms"]
                                        - r["policy_step_ms"])
                split = (f" (encode {r['encode_ms']:.1f} over {encodes} encodes, env "
                         f"{r['env_ms']:.1f}, policy step {r['policy_step_ms']:.1f}, rest "
                         f"{r['rollout_rest_ms']:.1f})")
            rows.append(r)
            print(f"[9 {label}] iteration {it} ({'instrumented' if on else 'plain'}): "
                  f"{r['iteration_ms']:.1f} ms (host clock {wall:.1f}, of which Python's "
                  f"GC {gc_t.ms:.1f}) = rollout {r['rollout_ms']:.1f}{split} + update "
                  f"{r['update_ms']:.1f}"
                  + (f" (gradient all-reduces {r['allreduce_ms']:.1f} over "
                     f"{len(red_t.spans)})" if on else "")
                  + f"; {r['env_steps_per_s']:.0f} env-steps/s; loss {loss:.4f}; launches "
                  f"{got}; {smi}")
            if it == 0:
                fid = rollout_fidelity(frames0, rollout.obs["visual"][0], label)
                held = hold_rollout_calls(fe, frames0, label)
        changed = any(not torch.equal(a, b) for a, b in zip(before, policy.parameters()))
        check(changed, f"{label}: the policy's weights changed")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        above = peak - resident / 2 ** 30
        print(f"[9 {label}] peak device memory {peak:.2f} GiB, {above:.2f} GiB above what "
              f"was allocated before the iterations (earlier phases' encoders included); "
              f"{smi}")
        later = rows[1:]
        for on in (True, False):
            ms = [r["iteration_ms"] for r in later if r["instrumented"] == on]
            if ms:
                print(f"[9 {label}] after the first iteration, "
                      f"{'instrumented' if on else 'plain'}: {min(ms):.1f} / "
                      f"{float(np.median(ms)):.1f} / {max(ms):.1f} ms an iteration (least / "
                      f"median / most of {len(ms)}); {smi}")
        out["launches"][label] = got
        out["rollout_calls_held"][label] = held
        out["iterations"][label] = {"rows": rows, "peak_gib": peak,
                                    "peak_above_start_gib": above, "cosine_vs_f32": fid}
        if profile and label == "bf16":
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as torch_profile

            for phase in ("rollout", "update"):
                with torch_profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
                    if phase == "rollout":
                        rollout, last_value, act, _ = learner.collect(act, gen)
                    else:
                        learner.update(rollout, last_value)
                    torch.cuda.synchronize()
                busy = busy_ms(prof)
                unprofiled = min(r[f"{phase}_ms"] for r in later)
                print(f"[9] bf16 {phase}, profiled: device busy {busy:.1f} ms (the union of "
                      f"the device's intervals), {busy / unprofiled:.1%} of the fastest "
                      f"unprofiled {phase} ({unprofiled:.1f} ms); device time by op:")
                print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
                out["iterations"][label][f"{phase}_device_busy_ms"] = busy
        return frames0

    # bf16: a first iteration (cuDNN's first calls), then plain and instrumented in turns.
    frames = run("bf16", False, (True,) + (False, True, True, False) * turns)
    run("int8", True, (True,))

    # K1 at the rollout's shape: 32 frames of 56x56, upscaled to 224.
    out["k1_rollout_shape"] = hold_k1(frames, card, smi, "9", "the rollout's shape")
    dist.destroy_process_group()
    return out


class EncodeProbe:
    """The frozen encoder as a learner's `encode_fn`, with CUDA-event spans around each
    call (`spans`), the frames and features of the first call after `capture()` kept
    (`first`), and an optional SIGKILL of a worker process at the k-th call from
    `kill_at(k, proc)` (counted from that call; the process is joined before the
    encode returns, so the worker is dead before its action is sent)."""

    def __init__(self, fn, spans: "EventSpans"):
        self.fn, self.spans, self.first, self._kill = spans.wrap(fn), spans, None, None
        self._armed = False

    def capture(self):
        self.first, self._armed = None, True

    def kill_at(self, k: int, proc):
        self._kill = [k, proc]

    def __call__(self, frames):
        if self._kill is not None:
            self._kill[0] -= 1
            if self._kill[0] < 0:
                self._kill[1].kill()  # SIGKILL
                self._kill[1].join(timeout=10)
                self._kill = None
        out = self.fn(frames)
        if self._armed:
            self.first, self._armed = (frames.clone(), out.clone()), False
        return out


def busy_ms(prof) -> float:
    """The union of the device's kernel (and copy) intervals of a torch.profiler run."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3


def check_host_path(card, smi, profile):
    """Phase 10: the host-simulator path at full width. Pools of THOR workers (the
    scripted controller of tests/fake_thor.py at 300×300) feed the folded clip_rn50
    encoder and the allenact policy on the card: (a) host PPO, bf16; (b) two pipelined
    groups; (c) int8 path A; (d) a worker SIGKILLed mid-rollout; (e) host evaluation;
    (f) host DAgger on the 1-phase rearrangement, both views encoded; (g) K1 at
    Habitat's frame shape."""
    import functools
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from embodied_clip_tpu_torch import constants
    from embodied_clip_tpu_torch.envs.thor import THORObjectNavEnv
    from embodied_clip_tpu_torch.envs.thor_rearrange import REARRANGE_ACTIONS, THORRearrangeEnv
    from embodied_clip_tpu_torch.envs.vector import VectorEnv, stop_fork_server
    from embodied_clip_tpu_torch.models.allenact_policy import AllenActResnetPolicy
    from embodied_clip_tpu_torch.models.encoders import build_encoder
    from embodied_clip_tpu_torch.native.frame_ring import frame_ring_available
    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
    from embodied_clip_tpu_torch.ops.kernels import preprocess_kernel as K
    from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK
    from embodied_clip_tpu_torch.ops.quantize import KERNELS_OFF
    from embodied_clip_tpu_torch.parallel.distributed import initialize_distributed
    from embodied_clip_tpu_torch.parallel.dryrun import free_port
    from embodied_clip_tpu_torch.parity import cosine_distance, golden_frames
    from embodied_clip_tpu_torch.training.dagger import DAggerConfig, HostDAggerLearner
    from embodied_clip_tpu_torch.training.ddppo import DDPPOConfig
    from embodied_clip_tpu_torch.training.evaluate import (
        compute_scores,
        evaluate_policy_host,
        write_metrics_json,
    )
    from embodied_clip_tpu_torch.training.frames import frozen_encode_fn
    from embodied_clip_tpu_torch.training.host_ppo import HostPPOLearner
    from embodied_clip_tpu_torch.training.ppo import PPOConfig

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from fake_thor import FakeController

    check(frame_ring_available(), "the shared-memory frame ring builds and loads")
    print("[10] simulators: the port's THORObjectNavEnv and THORRearrangeEnv over "
          "tests/fake_thor.FakeController, a scripted numpy stand-in for "
          "ai2thor.Controller (neither ai2thor nor habitat-sim is installed here), "
          "300x300 frames; pools from VectorEnv's fork server, started after CUDA is up")
    T, W, frame = 64, 8, (300, 300, 3)
    train = [f"FloorPlan_Train{i}_{j}" for i in range(1, 13) for j in range(1, 6)]
    val = [f"FloorPlan_Val{i}_{j}" for i in range(1, 4) for j in range(1, 6)]

    def objectnav_pool(seeds, scenes=train, **kw):
        venv = VectorEnv([functools.partial(THORObjectNavEnv, scenes, seed=s,
                                            controller_factory=FakeController, **kw)
                          for s in seeds], frame_shape=frame, max_steps=kw.get("max_steps"))
        check(venv.ring is not None, "the pool moves frames through the frame ring")
        return venv

    counted = {"fused_preprocess": K.fused_preprocess, "fused_stage1": BK.fused_stage1,
               "fused_bottleneck": BK.fused_bottleneck,
               "stem3_requant_pool_int8": SK.stem3_requant_pool_int8,
               "fused_stage1_int8": BK.fused_stage1_int8,
               "fused_resblocks_int8": BK.fused_resblocks_int8,
               "fused_cb3_cb1_int8": BK.fused_cb3_cb1_int8}
    per_encode = {"bf16": {"fused_preprocess": 1, "fused_stage1": 1, "fused_bottleneck": 10},
                  "int8": PER_REQUEST["A"]}
    cfg = DDPPOConfig(rollout_len=T, ppo=PPOConfig(lr=3e-4, epochs=4))
    f32 = build_encoder("clip_rn50", dtype=torch.float32, device="cuda")
    out = {"env_steps_per_s": {}, "rollout_calls_held": {}}

    def zero_counts():
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.launches = 0

    def check_counts(label, encodes, what):
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in counted.items()}
        exp = {k: per_encode[label].get(k, 0) * encodes for k in counted}
        check(got == exp, f"{what}: launches {got}, expected {exp}")
        return got

    def fidelity(probe):
        frames, stored = probe.first
        cos = cosine_distance(stored, f32.encode(frames)["clip_conv"])
        print(f"[10a bf16] stored clip_conv of act step 0 vs the f32 unfolded encoder on "
              f"the same {tuple(frames.shape)} frames: cosine {cos:.3e} (limit "
              f"{COSINE_LIMIT:g})")
        check(cos <= COSINE_LIMIT, f"bf16 host-rollout features within {COSINE_LIMIT:g} "
              "of f32")
        return frames, cos

    def report(sub, label, it, m, probe, launches, act_encodes=T):
        enc_ms = sum(a.elapsed_time(b) for a, b in probe.spans.spans[:act_encodes])
        share = enc_ms / (m["act_s"] * 1e3)
        print(f"[10{sub} {label}] iteration {it}: {m['env_steps_per_s']:.1f} env-steps/s "
              f"({m['env_steps']:.0f} env steps); act {m['act_s'] * 1e3:.1f} ms "
              f"({m['act_frac']:.1%}), env_step {m['env_step_s'] * 1e3:.1f} ms "
              f"({m['env_step_frac']:.1%}), update {m['update_s'] * 1e3:.1f} ms "
              f"({m['update_frac']:.1%}); encode {enc_ms:.1f} ms over the {act_encodes} act "
              f"steps' encodes = {share:.1%} of act; loss {m['loss']:.4f}; episodes "
              f"{m['episodes']:.0f}; launches {launches}; {smi}")
        return {k: m[k] for k in ("env_steps_per_s", "act_s", "act_frac", "env_step_s",
                                  "env_step_frac", "update_s", "update_frac", "loss",
                                  "episodes")} | {"encode_ms": enc_ms,
                                                  "encode_share_of_act": share}

    # The host learners' collectives (the global env count, the weights' broadcast, the
    # batch statistics and the gradient all-reduce) run through NCCL on the card.
    check(initialize_distributed(f"localhost:{free_port()}", 1, 0, device="cuda")
          and dist.get_backend() == "nccl", "a one-process NCCL group")
    print(f"[10] torch.distributed: {dist.get_backend()} group of {dist.get_world_size()}")
    pools = []
    try:
        fe, is_map = frozen_encode_fn("clip_rn50", torch.bfloat16, device="cuda")
        check(is_map and fe.feature_shape == (7, 7, 2048), "clip_rn50 conv map")

        # -- (a) host PPO, bf16 ---------------------------------------------------
        venv = objectnav_pool(range(W))
        pools.append(venv)
        probe = EncodeProbe(fe, EventSpans())
        policy = AllenActResnetPolicy()
        learner = HostPPOLearner(venv, policy, cfg, encode_fn=probe, device="cuda")
        learner.init(seed=1)
        before = [p.detach().clone() for p in policy.parameters()]
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        rows = []
        for it in range(3):
            probe.spans.reset()
            if it == 0:
                probe.capture()
            zero_counts()
            m = learner.train_iteration()
            got = check_counts("bf16", T + 1, f"(a) iteration {it}")
            check(np.isfinite(m["loss"]), "(a) loss finite")
            rows.append(report("a", "bf16", it, m, probe, got))
            if it == 0:
                frames, cos = fidelity(probe)
        check(any(not torch.equal(a, b) for a, b in zip(before, policy.parameters())),
              "(a) the policy's weights changed")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[10a] peak device memory {peak:.2f} GiB, "
              f"{peak - resident / 2 ** 30:.2f} GiB above what was allocated before the "
              f"iterations; {smi}")
        out["launches"] = got
        out["ppo_bf16"] = {"iterations": rows, "cosine_vs_f32": cos, "peak_gib": peak,
                           "peak_above_start_gib": peak - resident / 2 ** 30}
        out["env_steps_per_s"]["a_bf16_1_group"] = [r["env_steps_per_s"] for r in rows]
        out["rollout_calls_held"]["bf16"] = hold_rollout_calls(fe, frames, "bf16", "10a")
        out["k1_act_step_shape"] = hold_k1(frames, card, smi, "10a", "the act step's shape")
        if profile:
            busy = {}
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                rollout, last, _ = learner.collector.collect(T)
                torch.cuda.synchronize()
                wall = {"rollout": (time.perf_counter() - t0) * 1e3}
            busy["rollout"] = busy_ms(prof)
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                learner.update(rollout, last)
                torch.cuda.synchronize()
                wall["update"] = (time.perf_counter() - t0) * 1e3
            busy["update"] = busy_ms(prof)
            for k in busy:
                print(f"[10a] bf16 {k}, profiled: device busy {busy[k]:.1f} ms of "
                      f"{wall[k]:.1f} ms on the host's clock ({busy[k] / wall[k]:.1%})")
            print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))
            out["ppo_bf16"]["device_busy_ms"] = busy
            out["ppo_bf16"]["profiled_wall_ms"] = wall

        # -- (c) int8 path A, one iteration ------------------------------------------
        fe8, _ = frozen_encode_fn("clip_rn50", torch.bfloat16, int8=True, device="cuda")
        probe8 = EncodeProbe(fe8, EventSpans())
        learner8 = HostPPOLearner(venv, AllenActResnetPolicy(seed=2), cfg, encode_fn=probe8,
                                  device="cuda")
        learner8.init(seed=1)
        probe8.capture()
        zero_counts()
        m = learner8.train_iteration()
        got8 = check_counts("int8", T + 1, "(c) int8 iteration")
        check(np.isfinite(m["loss"]), "(c) loss finite")
        row8 = report("c", "int8", 0, m, probe8, got8)
        # The scripted controller renders one or two flat colours a frame; per-tensor
        # int8 PTQ is far from f32 on such frames in its plain graph too (the JAX int8
        # graph's math). So the stored features are held to the encoder's own output,
        # the encoder at the act step's batch to INT8_COSINE_LIMITS on golden frames,
        # and each kernel call to its plain version; the distance on the rollout's
        # frames is reported beside the plain graph's.
        frames8, stored8 = probe8.first
        check(torch.equal(stored8, fe8(frames8)), "(c) the stored features are the "
              "int8 encoder's on the act step's frames")
        g8 = golden_frames(8)
        got, ref = fe8.encoder.encode(g8), f32.encode(g8)
        cos8 = {k: cosine_distance(got[k], ref[k]) for k in ref}
        print(f"[10c int8] the act step's encoder at batch 8 on golden_frames(8) vs the "
              f"f32 unfolded encoder: " + ", ".join(
                  f"{k} {v:.3e} (limit {INT8_COSINE_LIMITS[k]:g})" for k, v in cos8.items()))
        check(all(v <= INT8_COSINE_LIMITS[k] for k, v in cos8.items()),
              f"(c) int8 encoder at batch 8 within {INT8_COSINE_LIMITS}")
        # The whole encode on the act step's frames: path A against the plain graph fed
        # by the same stem (K2, whose call is held below), so a fault of K3 or K5 or of
        # their chaining fails the run. The plain graph with its own stem is reported
        # beside it: it rounds the stem3 conv to bf16 before the requant, which K2 does
        # not, and on flat frames a flipped requant flips whole regions.
        ref8 = f32.encode(frames8)["clip_conv"]
        plain = fe8.encoder.with_kernels(**KERNELS_OFF).encode(frames8)["clip_conv"]
        zero_counts()
        k2_plain = fe8.encoder.with_kernels(**{**KERNELS_OFF, "kernel_stem": True}).encode(
            frames8)["clip_conv"]
        torch.cuda.synchronize()
        check({k: fn.launches for k, fn in counted.items() if fn.launches}
              == {"fused_preprocess": 1, "stem3_requant_pool_int8": 1},
              "(c) the plain graph fed by K2 launches K1 and K2 alone")
        cos_env = {"path_a": cosine_distance(stored8, ref8),
                   "plain_graph": cosine_distance(plain, ref8),
                   "path_a_vs_plain_graph_after_k2": cosine_distance(stored8, k2_plain),
                   "path_a_vs_plain_graph": cosine_distance(stored8, plain),
                   "plain_graph_after_k2_vs_plain_graph": cosine_distance(k2_plain, plain)}
        print(f"[10c int8] stored clip_conv of act step 0 vs the f32 unfolded encoder on "
              f"the same {tuple(frames8.shape)} frames: cosine {cos_env['path_a']:.3e}; the "
              f"plain int8 graph (no kernel) on them: {cos_env['plain_graph']:.3e}")
        print(f"[10c int8] stored clip_conv vs the plain int8 graph fed by K2's stem: "
              f"{cos_env['path_a_vs_plain_graph_after_k2']:.3e} (limit "
              f"{INT8_PLAIN_GRAPH_LIMIT:g}); vs the plain graph with its own stem: "
              f"{cos_env['path_a_vs_plain_graph']:.3e}, of which the two stems alone (the "
              f"plain graph after K2 vs the plain graph): "
              f"{cos_env['plain_graph_after_k2_vs_plain_graph']:.3e}")
        check(cos_env["path_a_vs_plain_graph_after_k2"] <= INT8_PLAIN_GRAPH_LIMIT,
              f"(c) the stored features within {INT8_PLAIN_GRAPH_LIMIT:g} of the plain int8 "
              "graph fed by K2 on the act step's frames")
        out["ppo_int8"] = row8 | {"cosine_vs_f32_golden8": cos8,
                                  "cosine_vs_f32_rollout_frames": cos_env, "launches": got8}
        out["env_steps_per_s"]["c_int8_1_group"] = [m["env_steps_per_s"]]
        out["rollout_calls_held"]["int8"] = hold_rollout_calls(fe8, frames8, "int8", "10c")

        # -- (d) a worker SIGKILLed in the middle of a rollout --------------------------
        learner.init(seed=3)
        victim, at = 3, 20
        probe.kill_at(at, venv.procs[victim])
        zero_counts()
        rollout, last, env_m = learner.collector.collect(T)
        metrics = learner.update(rollout, last)
        check_counts("bf16", T + 1, "(d) rollout with a killed worker")
        invalid = (~rollout.valid).nonzero().tolist()
        print(f"[10d] worker {victim} SIGKILLed at act step {at}: respawns "
              f"{venv.respawn_count}, worker alive {venv.procs[victim].is_alive()}, "
              f"(step, env) pairs masked invalid {invalid}, done flagged at "
              f"{rollout.dones[:, victim].nonzero().flatten().tolist()}; loss "
              f"{float(metrics['loss']):.4f}")
        check(venv.respawn_count == 1 and venv.procs[victim].is_alive(),
              "(d) the killed worker was respawned")
        check(invalid == [[at, victim], [at + 1, victim]] and bool(rollout.dones[at + 1, victim]),
              "(d) the killed worker's step and the respawned worker's first step are "
              "masked invalid, the latter flagged done")
        check(np.isfinite(float(metrics["loss"])), "(d) the iteration completes")
        out["worker_killed"] = {"respawns": venv.respawn_count, "invalid": invalid}

        # -- (e) host evaluation ---------------------------------------------------------
        eval_pool = objectnav_pool(range(100, 100 + W), val, max_steps=40)
        pools.append(eval_pool)
        t0 = time.perf_counter()
        eps = evaluate_policy_host(eval_pool, policy, 16, 6, deterministic=True,
                                   encode_fn=fe, class_names=constants.ROBOTHOR_OBJECT_TYPES,
                                   device="cuda")
        eval_s = time.perf_counter() - t0
        check(len(eps) == 16 and all(0 <= e["success"] <= 1 and 0 <= e["spl"] <= 1
                                     and e["ep_length"] > 0 for e in eps),
              "(e) 16 evaluation episodes delivered")
        with tempfile.TemporaryDirectory() as tmp:
            path = write_metrics_json(os.path.join(tmp, "metrics.json"), eps)
            types = sorted({e["task_info"]["object_type"] for e in eps})
            scores = {t: compute_scores(path, t) for t in types}
        print(f"[10e] evaluate_policy_host (deterministic, val scenes, horizon 40): 16 "
              f"episodes in {eval_s:.2f} s; success/SPL by object type {scores}")
        out["eval"] = {"episodes": len(eps), "seconds": eval_s, "scores": scores}
        for p in pools:
            p.close()
        pools = []

        # -- (b) two pipelined groups of 8 workers -------------------------------------
        groups = [objectnav_pool(range(g * W, (g + 1) * W)) for g in range(2)]
        pools.extend(groups)
        probe2 = EncodeProbe(fe, EventSpans())
        learner2 = HostPPOLearner(groups, AllenActResnetPolicy(seed=4), cfg,
                                  encode_fn=probe2, device="cuda")
        learner2.init(seed=1)
        rows2 = []
        for it in range(2):
            probe2.spans.reset()
            zero_counts()
            m = learner2.train_iteration()
            got2 = check_counts("bf16", 2 * (T + 1), f"(b) iteration {it}")
            check(np.isfinite(m["loss"]), "(b) loss finite")
            rows2.append(report("b", "bf16", it, m, probe2, got2, 2 * T))
        out["pipelined_bf16"] = rows2
        out["env_steps_per_s"]["b_bf16_2_groups"] = [r["env_steps_per_s"] for r in rows2]
        print(f"[10b] env-steps/s, 1 group of 8 (a): "
              f"{', '.join(f'{r:.1f}' for r in out['env_steps_per_s']['a_bf16_1_group'])}; "
              f"2 pipelined groups of 8 (b): "
              f"{', '.join(f'{r:.1f}' for r in out['env_steps_per_s']['b_bf16_2_groups'])}; "
              f"int8, 1 group (c): {out['env_steps_per_s']['c_int8_1_group'][0]:.1f}; {smi}")
        for p in pools:
            p.close()
        pools = []

        # -- (f) host DAgger on the 1-phase rearrangement, both views --------------------
        rooms = [f"FloorPlan{i}" for i in range(1, 21)]
        rvenv = VectorEnv([functools.partial(THORRearrangeEnv, rooms, seed=s,
                                             controller_factory=FakeController)
                           for s in range(W)], frame_shape=frame)
        pools.append(rvenv)
        check(rvenv.ring is not None, "the rearrangement pool uses the frame ring")
        probe_r = EncodeProbe(fe, EventSpans())
        rpolicy = AllenActResnetPolicy(in_channels=2 * 2048,
                                       num_actions=len(REARRANGE_ACTIONS), seed=5)
        dagger = HostDAggerLearner(rvenv, rpolicy, DAggerConfig(
            rollout_len=T, epochs=2, lr=3e-4, beta_decay_iters=4, aggregate_size=2),
            encode_fn=probe_r, device="cuda")
        dagger.init(seed=1)
        rows_f = []
        for it in range(2):
            probe_r.spans.reset()
            zero_counts()
            m = dagger.train_iteration(it)
            got_f = check_counts("bf16", 2 * T, f"(f) DAgger iteration {it}")
            check(np.isfinite(m["loss"]) and 0.0 <= m["expert_match"] <= 1.0,
                  "(f) loss finite, expert_match in [0, 1]")
            agg = dagger.aggregate.items
            check(len(agg) == it + 1 and agg[-1][0]["visual"].device.type == "cpu"
                  and tuple(agg[-1][0]["visual"].shape) == (T, W, 7, 7, 4096),
                  "(f) the aggregate in host memory, 4096-channel maps")
            enc_ms = sum(a.elapsed_time(b) for a, b in probe_r.spans.spans)
            print(f"[10f] DAgger iteration {it} (beta {m['beta']:.2f}): "
                  f"{m['env_steps_per_s']:.1f} env-steps/s; act {m['act_s'] * 1e3:.1f} ms "
                  f"({m['act_frac']:.1%}), env_step (experts + steps) "
                  f"{m['env_step_s'] * 1e3:.1f} ms ({m['env_step_frac']:.1%}), update "
                  f"{m['update_s'] * 1e3:.1f} ms ({m['update_frac']:.1%}); encode "
                  f"{enc_ms:.1f} ms over {2 * T} encodes; loss {m['loss']:.4f}, "
                  f"expert_match {m['expert_match']:.3f}; aggregate {len(agg)} rollouts "
                  f"of {agg[-1][0]['visual'].nbytes / 2 ** 20:.0f} MiB of features in host "
                  f"memory; launches {got_f}; {smi}")
            rows_f.append({k: m[k] for k in ("env_steps_per_s", "act_s", "env_step_s",
                                             "update_s", "loss", "expert_match")}
                          | {"encode_ms": enc_ms, "launches": got_f})
        out["dagger"] = rows_f
        for p in pools:
            p.close()
        pools = []
        # The workers are the fork server's children: none may outlive its pool.
        workers = [pid for pid, pp in descendants().items() if pp != os.getpid()]
        check(not workers, f"(close) every pool's workers have ended, left: {workers}")
    finally:
        for p in pools:
            p.close()
        dist.destroy_process_group()
        stop_fork_server()
    left = descendants()
    check(not left, f"(close) the fork server and the resource tracker have ended, "
                    f"left: {left}")
    print("[10] pools closed: every worker, the fork server and the resource tracker "
          "have ended")

    # -- (g) K1 at Habitat's frame shape ---------------------------------------------
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randint(0, 256, (W, 480, 640, 3), generator=g, device="cuda",
                      dtype=torch.uint8)
    out["k1_habitat_shape"] = hold_k1(x, card, smi, "10g", "Habitat's frame shape")
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    import numpy as np

    from embodied_clip_tpu_torch import constants
    from embodied_clip_tpu_torch.models.encoders import build_encoder
    from embodied_clip_tpu_torch.ops.kernels import _build
    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
    from embodied_clip_tpu_torch.ops.kernels import preprocess_kernel as K
    from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK
    from embodied_clip_tpu_torch.ops.quantize import PATH_B
    from embodied_clip_tpu_torch.parity import cosine_distance, golden_frames

    profile = "--profile" in argv
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[1] torch {torch.__version__} (CUDA {torch.version.cuda}) on {kind}")
    print(smi)

    t0 = time.perf_counter()
    _build.build(_build.SOURCES)
    print(f"[2] built {', '.join(_build.SOURCES)} in {time.perf_counter() - t0:.2f} s")
    for src in _build.SOURCES:
        for line in _build.build_log(src).splitlines():
            if "ptxas info    : Used" in line or "(C75" in line:
                print(f"[2]   {src}: {line.strip()}")
    # K6/K7's GEMM runs on bf16 wgmma: its SASS holds HGMMA and no mma.sync (HMMA); K2's
    # conv on bf16 wgmma (HGMMA); K3-K5's s8 products on s8 wgmma (IGMMA) and K3's
    # shortcut on bf16 wgmma (HGMMA), with no dp4a on the CUDA cores (IDP.4A); K1 stages
    # its input bands with the 1-D bulk copy (UBLKCP).
    for src, wants, banned in (("bottleneck_bf16", ("HGMMA.",), "HMMA."),
                               ("stem_int8", ("HGMMA.",), "HMMA."),
                               ("bottleneck_int8", ("IGMMA", "HGMMA."), "IDP.4A"),
                               ("preprocess", ("UBLKCP",), None)):
        sass = subprocess.run([shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump",
                               "-sass", str(_build.library_path(src))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        counts = {w: sass.count(w) for w in wants}
        n_banned = sass.count(banned) if banned else 0
        print(f"[2] {src} SASS: " + ", ".join(f"{n} {w.rstrip('.')}" for w, n in counts.items())
              + " instructions" + (f", {n_banned} {banned.rstrip('.')}" if banned else ""))
        check(all(counts.values()) and n_banned == 0,
              f"{src} holds {', '.join(wants)}" + (f" and no {banned}" if banned else ""))

    # Full-f32 references: cuDNN convs and cuBLAS matmuls default to TF32 otherwise.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[3] TF32 off (torch.backends.cudnn.allow_tf32 = "
          "torch.backends.cuda.matmul.allow_tf32 = False)")

    # -- 3. K1 against its plain version, at the main path's shape --------------------
    mean, std = constants.CLIP_MEAN, constants.CLIP_STD
    lsb = 1.0 / 255.0 / min(std)
    frames = torch.from_numpy(golden_frames(128)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        check(torch.equal(K.fused_preprocess(frames, 224, mean, std, dtype=dtype),
                          K.fused_preprocess_reference(frames, 224, mean, std, dtype=dtype)),
              f"K1 bit-equal to its plain version at (128, 300, 300) → 224, {dtype}")
    print("[3] K1 (128, 300, 300) → 224: bit-equal to its plain version, f32 and bf16")

    def at_offset(x, offset):  # the same frames at a data_ptr `offset` bytes past 256
        buf = torch.empty(offset + x.numel(), dtype=torch.uint8, device=dev)
        y = buf[offset:].view(x.shape)
        y.copy_(x)
        return y

    worst_lsb = max_abs = 0.0
    cases = [(frames, 224), (frames[:1], 224), (frames[:5], 224),
             (at_offset(frames[:3], 13), 224),
             (torch.from_numpy(golden_frames(4, size=160)[:, :, :120].copy()), 224),
             (at_offset(torch.from_numpy(golden_frames(4, size=301)[:, :, :299].copy())
                        .to(dev), 1), 224)]
    # main shape at batches 128, 1 and 5, a misaligned view, an upscale, an odd width
    for x, size in cases:
        x = x.to(dev)
        before = K.fused_preprocess.launches
        k32 = K.fused_preprocess(x, size, mean, std, dtype=torch.float32)
        kbf = K.fused_preprocess(x, size, mean, std, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        check(K.fused_preprocess.launches == before + 2, "K1 launch count")
        ref = K.fused_preprocess_reference(x, size, mean, std, dtype=torch.float32)
        err = (k32 - ref).abs()
        flipped = float((err > 0.5 * lsb).float().mean())
        print(f"[3] K1 {tuple(x.shape)} at data_ptr % 16 = {x.data_ptr() % 16} → {size}: "
              f"max {float(err.max()) / lsb:.4f} LSB, flipped {flipped:.2e} (limits "
              f"{LSB_LIMIT} LSB, {FLIP_LIMIT:g} flipped)")
        check(float(err.max()) <= LSB_LIMIT * lsb and flipped < FLIP_LIMIT,
              f"K1 vs plain version on {tuple(x.shape)}")
        check(torch.equal(kbf, k32.to(torch.bfloat16)), "K1 bf16 == f32 output cast")
        worst_lsb = max(worst_lsb, float(err.max()) / lsb)
        max_abs = max(max_abs, float(err.max()))

    card = card_rates(kind)
    bw, f32_peak = card[1], card[2]
    k1_times = {}
    for n_k1 in (128, 1):
        x = frames[:n_k1]
        nchw = x.permute(0, 3, 1, 2).float().contiguous()
        t = {"ms": cuda_ms(lambda: K.fused_preprocess(x, 224, mean, std), 200),
             "ms_f32": cuda_ms(lambda: K.fused_preprocess(x, 224, mean, std,
                                                          dtype=torch.float32), 200),
             "plain_ms": cuda_ms(lambda: K.fused_preprocess_reference(x, 224, mean, std),
                                 10),
             "interpolate_ms": cuda_ms(lambda: torch.nn.functional.interpolate(
                 nchw, size=(224, 224), mode="bicubic", antialias=True), 50)}
        pp_bytes, flops = preprocess_work(n_k1, (300, 300), 224, 2)
        bytes_ms, ops_ms = pp_bytes / bw * 1e3, flops / f32_peak * 1e3
        t["bound_ms"] = max(bytes_ms, ops_ms)
        t["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        k1_times[n_k1] = t
        print(f"[3] K1 batch {n_k1} bf16: kernel {t['ms']:.4f} ms (f32 out {t['ms_f32']:.4f}),"
              f" plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by "
              f"{t['bound_by']} ({pp_bytes} B at {bw:.3g} B/s, {flops} FLOP at "
              f"{f32_peak:.3g} FLOP/s, {card[0]}); {pp_bytes / t['ms'] / 1e6:.1f} GB/s "
              f"achieved, {t['bound_ms'] / t['ms']:.1%} of the bound; yardstick "
              f"interpolate(bicubic, antialias) of an f32 NCHW copy {t['interpolate_ms']:.4f}"
              f" ms; {smi}")
    kernel_ms, plain_ms = k1_times[128]["ms"], k1_times[128]["plain_ms"]
    bound_ms, bound_by = k1_times[128]["bound_ms"], k1_times[128]["bound_by"]

    # -- 4. the bf16 path: BN-folded clip_rn50 serving requests -------------------------
    base = build_encoder("clip_rn50", dtype=torch.bfloat16, device="cuda")
    enc = base.fold_bn()
    rng = np.random.RandomState(1)
    reqs = []
    for n, layout in REQUESTS:
        f = rng.randint(0, 256, (n, 300, 300, 3), np.uint8)
        reqs.append(f.reshape(n, 300, 900) if layout == "flat" else f)
    bf16_counted = {"fused_preprocess": K.fused_preprocess, "fused_stage1": BK.fused_stage1,
                    "fused_bottleneck": BK.fused_bottleneck}

    def serve(encoder, label, model="clip_rn50"):
        t0 = time.perf_counter()
        outs = [encoder.encode(f) for f in reqs]
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        for (n, layout), out in zip(REQUESTS, outs):
            shapes = {k: tuple(v.shape) for k, v in out.items()}
            want = {k: (n, *v) for k, v in FEATURE_SHAPES[model].items()}
            check(shapes == want, f"{model} response shapes {shapes}")
            check(all(v.dtype == torch.bfloat16 and bool(torch.isfinite(v).all())
                      for v in out.values()), f"finite bf16 features for batch {n}")
        print(f"[{label}] {model}: {len(REQUESTS)} requests ({sum(n for n, _ in REQUESTS)} "
              f"frames, batches {', '.join(f'{n} {lay}' for n, lay in REQUESTS)}, first call "
              f"included) in {serve_s:.3f} s: keys, shapes, finite bf16 ok")

    def serve_bf16(encoder, label, model):
        """Serve the requests and check the launches per request of the bf16 path."""
        for fn in bf16_counted.values():
            fn.launches = 0  # count this path's launches only
        serve(encoder, label, model)
        got_l = {k: fn.launches for k, fn in bf16_counted.items()}
        want_l = {k: v * len(REQUESTS) for k, v in BF16_PER_REQUEST[model].items()}
        print(f"[{label}] {model} launches over {len(REQUESTS)} requests: {got_l}")
        check(got_l == want_l, f"{model} launches {got_l}, expected {want_l}")
        return got_l

    def fidelity(encoder, ref, label, limits):
        got = encoder.encode(g8)
        cos = {k: cosine_distance(got[k], ref[k]) for k in ref}
        print(f"[{label}] vs f32 unfolded (same weights, TF32 off), cosine distance: "
              + ", ".join(f"{k} {v:.3e} (limit {limits[k]:g})" for k, v in cos.items()))
        check(all(v <= limits[k] for k, v in cos.items()), f"{label} cosine within {limits}")
        return cos

    def encode_times(encoders, label, model):
        """Batch-128 encode ms of each encoder, in turns (a, b, b, a)."""
        order = list(encoders) + list(reversed(encoders))
        times = {}
        for name in order:
            ms = cuda_ms(lambda: encoders[name].encode(x128), 10)
            times.setdefault(name, []).append(ms)
            print(f"[{label}] {model} {name} encode, batch 128 on the device: {ms:.3f} ms, "
                  f"{128 / ms * 1e3:.1f} frames/s on {smi}")
        return {name: min(v) for name, v in times.items()}

    bf16_launches = serve_bf16(enc, "4", "clip_rn50")
    launches = bf16_launches["fused_preprocess"]

    g8 = golden_frames(8)
    f32_ref = build_encoder("clip_rn50", dtype=torch.float32, device="cuda").encode(g8)
    limits = dict.fromkeys(f32_ref, COSINE_LIMIT)
    fidelity(enc, f32_ref, "4 bf16 folded, K6/K7", limits)
    enc_cudnn = base.fold_bn(fused_bottlenecks=False)
    check(not enc_cudnn.module.uses_fused_bottlenecks, "the cuDNN route is reachable")
    fidelity(enc_cudnn, f32_ref, "4 bf16 folded, cuDNN route", limits)

    x128 = torch.from_numpy(reqs[-1]).to(dev)
    clip_times = encode_times({"bf16 folded (K6/K7)": enc,
                               "bf16 folded (cuDNN route)": enc_cudnn}, "4", "clip_rn50")
    encode_ms = clip_times["bf16 folded (K6/K7)"]

    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                enc.encode(x128)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))

    # -- 5. K2-K5 against their plain versions on the main path's batch-128 inputs ------
    t0 = time.perf_counter()
    qenc = enc.quantize(golden_frames(32))
    torch.cuda.synchronize()
    print(f"[5] clip_rn50 quantized (calibrated on golden_frames(32)) in "
          f"{time.perf_counter() - t0:.2f} s")
    g128 = torch.from_numpy(golden_frames(128)).to(dev)
    int8_results = check_int8_kernels(qenc, g128, card, profile)

    # -- 6. the int8 main path: paths A and B serving the requests ----------------------
    qenc_b = qenc.with_kernels(**PATH_B)
    counted = {"fused_preprocess": K.fused_preprocess,
               "stem3_requant_pool_int8": SK.stem3_requant_pool_int8,
               "fused_stage1_int8": BK.fused_stage1_int8,
               "fused_resblocks_int8": BK.fused_resblocks_int8,
               "fused_cb3_cb1_int8": BK.fused_cb3_cb1_int8}
    path_launches = {}
    for path, encoder in (("A", qenc), ("B", qenc_b)):
        for fn in counted.values():
            fn.launches = 0  # count this path's launches only
        serve(encoder, f"6{path}")
        got_l = {k: fn.launches for k, fn in counted.items()}
        want_l = {k: v * len(REQUESTS) for k, v in PER_REQUEST[path].items()}
        print(f"[6{path}] launches over {len(REQUESTS)} requests: {got_l}")
        check(got_l == want_l, f"path {path} launches {got_l}, expected {want_l}")
        path_launches[path] = got_l

    cos8 = {}
    for path, encoder in (("A", qenc), ("B", qenc_b)):
        got = encoder.encode(g8)
        cos8[path] = {k: cosine_distance(got[k], f32_ref[k]) for k in f32_ref}
        print(f"[6{path}] int8 vs f32 unfolded (same weights, TF32 off), cosine distance: "
              + ", ".join(f"{k} {v:.3e} (limit {INT8_COSINE_LIMITS[k]:g})"
                          for k, v in cos8[path].items()))
        check(all(v <= INT8_COSINE_LIMITS[k] for k, v in cos8[path].items()),
              f"path {path} int8 cosine within {INT8_COSINE_LIMITS}")
    for frames_in, label in ((g8, "golden_frames(8)"), (x128, "request batch 128")):
        a, b = qenc.encode(frames_in), qenc_b.encode(frames_in)
        check(all(torch.equal(a[k], b[k]) for k in a), f"paths A and B agree on {label}")
        print(f"[6] paths A and B bit-identical on {label}")

    ms_a = cuda_ms(lambda: qenc.encode(x128), 5)
    ms_b = cuda_ms(lambda: qenc_b.encode(x128), 5)
    ms_a2 = cuda_ms(lambda: qenc.encode(x128), 5)
    for path, ms in (("A", ms_a), ("B", ms_b), ("A", ms_a2)):
        print(f"[6{path}] clip_rn50 int8 encode, batch 128 on the device: {ms:.3f} ms, "
              f"{128 / ms * 1e3:.1f} frames/s on {smi}")

    # -- 7. K6/K7 against their plain versions on batch-128 main-path inputs -------------
    ibase = build_encoder("imagenet_rn50", dtype=torch.bfloat16, device="cuda")
    ienc = ibase.fold_bn()
    with torch.inference_mode():
        bf16_results = check_bf16_kernels({"clip_rn50": enc, "imagenet_rn50": ienc}, g128,
                                          card)

    # -- 8. the ImageNet family: bf16 folded rn50/rn18, then rn50 int8 --------------------
    imagenet_launches, imagenet_ms, imagenet_cos = {}, {}, {}
    for model, folded in (("imagenet_rn50", ienc), ("imagenet_rn18", None)):
        unfolded = ibase if folded is not None else build_encoder(
            model, dtype=torch.bfloat16, device="cuda")
        folded = folded or unfolded.fold_bn()
        imagenet_launches[model] = serve_bf16(folded, "8", model)
        ref = build_encoder(model, dtype=torch.float32, device="cuda").encode(g8)
        imagenet_cos[model] = fidelity(folded, ref, f"8 {model} bf16 folded",
                                       dict.fromkeys(ref, COSINE_LIMIT))
        encoders = {"bf16 folded": folded}
        if model == "imagenet_rn50":
            encoders["bf16 folded (cuDNN route)"] = unfolded.fold_bn(fused_bottlenecks=False)
            iref = ref
        imagenet_ms[model] = encode_times(encoders, "8", model)
    t0 = time.perf_counter()
    iqenc = ienc.quantize(golden_frames(32))
    torch.cuda.synchronize()
    print(f"[8] imagenet_rn50 quantized (calibrated on golden_frames(32)) in "
          f"{time.perf_counter() - t0:.2f} s")
    serve(iqenc, "8 int8", "imagenet_rn50")
    imagenet_cos["imagenet_rn50 int8"] = fidelity(iqenc, iref, "8 imagenet_rn50 int8",
                                                  IMAGENET_INT8_COSINE_LIMITS)
    imagenet_ms["imagenet_rn50"]["int8"] = cuda_ms(lambda: iqenc.encode(x128), 5)
    print(f"[8] imagenet_rn50 int8 encode, batch 128 on the device: "
          f"{imagenet_ms['imagenet_rn50']['int8']:.3f} ms on {smi}")

    # -- 9. the DD-PPO step with the frozen encoder inside the rollout ------------------
    ddppo = check_ddppo(card, smi, profile)
    per_iter = {k: v for launches in ddppo["launches"].values() for k, v in launches.items()
                if v}

    # -- 10. the host-simulator path: worker pools feeding the encoder and the learners ---
    host = check_host_path(card, smi, profile)

    # -- 11. results ---------------------------------------------------------------------
    src = "embodied_clip_tpu_torch/csrc/"
    pallas = "embodied_clip_tpu/ops/pallas/"
    rows = [{
        "name": "fused_preprocess", "route": "cuda", "source": src + "preprocess.cu",
        "replaces": pallas + "preprocess_kernel.py:93",
        "launches": launches, "max_abs_err": max_abs, "max_err_lsb": worst_lsb,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "ms_f32_out": k1_times[128]["ms_f32"],
        "interpolate_yardstick_ms": k1_times[128]["interpolate_ms"],
        "batch1": {k: k1_times[1][k] for k in ("ms", "ms_f32", "plain_ms", "interpolate_ms",
                                               "bound_ms", "bound_by")},
        "ddppo_rollout_shape": ddppo["k1_rollout_shape"],
        "ms_unit": "per batch-128 bf16 call"}]
    for name, source, replaces, path in (
            ("stem3_requant_pool_int8", "stem_int8.cu", "stem_kernel.py:79", "A"),
            ("fused_stage1_int8", "bottleneck_int8.cu", "bottleneck_kernel.py:312", "A"),
            ("fused_cb3_cb1_int8", "bottleneck_int8.cu", "bottleneck_kernel.py:537", "B"),
            ("fused_resblocks_int8", "bottleneck_int8.cu", "bottleneck_kernel.py:426", "A")):
        rows.append({"name": name, "route": "cuda", "source": src + source,
                     "replaces": pallas + replaces, "launches": path_launches[path][name],
                     "path": path, **int8_results[name], "library_ms": None,
                     "ms_unit": "per batch-128 encode (all calls)"})
    for name, replaces in (("fused_bottleneck", "bottleneck_kernel.py:81"),
                           ("fused_stage1", "bottleneck_kernel.py:164")):
        r = bf16_results[name]
        rows.append({"name": name, "route": "cuda", "source": src + "bottleneck_bf16.cu",
                     "replaces": pallas + replaces, "launches": bf16_launches[name],
                     "launches_imagenet_rn50": imagenet_launches["imagenet_rn50"][name],
                     "max_abs_err": r["max_abs_err"], "share_differing": r["share"],
                     "worst_of_allowance": r["worst"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": max(r["by"], key=r["by"].get),
                     "cudnn_route_ms": r["cudnn_route_ms"], "library_ms": None,
                     "ms_unit": "per batch-128 clip_rn50 encode (all calls)",
                     "calls": r["calls"]})
    print(json.dumps({"encode_ms_batch128": {"clip_rn50": {**clip_times, "int8_path_a": ms_a,
                                                           "int8_path_a_again": ms_a2,
                                                           "int8_path_b": ms_b},
                                             **imagenet_ms},
                      "cosine_vs_f32": {k: v for k, v in imagenet_cos.items()},
                      "card": smi}))
    held = {k: v for calls in ddppo["rollout_calls_held"].values() for k, v in calls.items()}
    host_held = {k: v for calls in host["rollout_calls_held"].values()
                 for k, v in calls.items()}
    host_per_iter = {**host["ppo_int8"]["launches"],
                     **{k: v for k, v in host["launches"].items() if v}}
    for row in rows:
        row["launches_ddppo_iteration"] = per_iter.get(row["name"], 0)
        if row["name"] in held:
            row["ddppo_rollout_calls_held"] = held[row["name"]]
        row["launches_host_ppo_iteration"] = host_per_iter.get(row["name"], 0)
        if row["name"] in host_held:
            row["host_rollout_calls_held"] = host_held[row["name"]]
    rows[0]["host_act_step_shape"] = host["k1_act_step_shape"]  # K1
    rows[0]["host_habitat_shape"] = host["k1_habitat_shape"]
    print(json.dumps({"ddppo": {k: v for k, v in ddppo.items() if k != "k1_rollout_shape"},
                      "card": smi}))
    print(json.dumps({"host": {k: v for k, v in host.items()
                               if k not in ("k1_act_step_shape", "k1_habitat_shape")},
                      "card": smi}))
    check(not descendants(), f"every process the script started has ended, left: "
                             f"{descendants()}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
