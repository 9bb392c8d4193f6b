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
     its stride shortcut (e) bf16 wgmma with both operands from shared memory and no
     float → bf16 conversion (that is (f')'s, once), its 2×2 pool kernel (f) 128-bit
     loads and stores (the shortcut's registers and spills printed), that of
     `preprocess` (K1) the 1-D bulk copy (UBLKCP), and that of `attention_bf16` bf16 wgmma
     (HGMMA) and no mma.sync (HMMA);
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
     and the launches per request (K1 1, K7 1, K6 10, bf16 stride block 3: CLIP's
     anti-aliased stride-2 blocks on the bf16 GEMM and the 2×2 pool P); hold the bf16
     features to the
     port's unfolded f32 encoder (TF32 off) at ≤1e-3 cosine; time a batch-128 encode;
  5. quantize that encoder (calibrated on golden_frames(32)) and encode
     golden_frames(128) through path A (stem12 + K2 + K3 + K5 + the stride blocks) and
     path B (stem12 + K2 + K3 + K4 + the stride blocks up to cb3), recording every kernel
     call's inputs; hold stem12 to its plain version at ≤1 bf16 step (counted at no less
     than the output's RMS) on ≤0.1% of elements (`parity.stem12_step_disagreement`; its
     bound is f32 FMA's, its `library_ms` cuDNN's two f32 convs alone), K2 and K3 to
     their plain versions at ≤1 s8 step on ≤0.5% of elements, K4 and
     K5 bit-exactly, and every stride-block call of both paths with o8 (cb1, cb2, the
     pools) and cb3 (on the kernel's own o8 and id8) bit-exact, id8 and the block output
     at ≤1 step on ≤0.5%, and id8 equal to the exact sum's requant
     (`parity.stride_block_disagreement`; so on every stride-block call of phases 5,
     9-11, 13 and 14); each of path A's stride blocks launch by launch: (f') bit-equal to
     its plain version, (e) equal to the exact sum's requant, its share apart from the
     plain graph's f32 product and its near-tie share printed, each launch kind timed
     against its bound ((e) and (f') also replayed from a CUDA graph), the library's
     route of the block's products beside it (never called by the port); time each kernel
     and its
     plain version on those inputs (back-to-back wrapper calls between CUDA events, as
     every kernel's `ms`; beside it `device_ms`, the calls replayed from a CUDA graph,
     which leaves out the host's share), compute its bound, and print each call's
     achieved TOP/s and share of the bound; time K3's entry launch (cb1a and the conv
     shortcut) alone against its bound; beside K2 and that launch, a yardstick timed the
     same way that the port never calls: cuDNN's bf16 conv of the same stem3 shape
     (channels-last, the conv alone) and `torch.matmul` of the shortcut's bf16 product;
  6. drive the int8 main path: the four requests through path A, with launches per
     request K1 1, stem12 1, K2 1, K3 1, K5 3, stride block 3; the same through path B,
     with K4 12
     and stride block 3 per request; keys, shapes, finite bf16; cosine distance vs the
     f32 encoder ≤1e-3 for the pooled keys and ≤2e-3 for the conv map
     (`INT8_COSINE_LIMITS`); paths A and B bit-identical; batch-128 encode times of both
     paths, and of path A with `kernel_stride_blocks=False` in turns with the default;
     no call of `ops/int8.qmm` or `im2col3x3` during a path A encode;
  7. record every K6/K7 and bf16 stride-block call of a batch-128 `clip_rn50` encode and
     of an `imagenet_rn50` encode; hold each to its plain version
     (`parity.bf16_disagreement`: ≤1% of elements differ, each within two bf16 steps; K7
     block by block, `parity.stage1_block_disagreements`, its chained output reported);
     time the kernel, the plain version and the same block(s) on the eager cuDNN route,
     compute the bound, and print each call's achieved TFLOP/s and share of the bound;
     clip_rn50's stride blocks launch by launch (`bf16_stride_parts`): P bit-equal to
     `F.avg_pool2d` and its plain version, (c) held on the launches' own p and xp, (a) /
     (b) / P / (c) each timed against its bound, `F.avg_pool2d` of the same tensors beside;
  8. the ImageNet family: bf16 folded `imagenet_rn50` and `imagenet_rn18` serve the four
     requests (shapes, finite bf16, launches per request: rn50 K1 1, K7 1, K6 10, its
     stride blocks on cuDNN; rn18 K1 1 and no K6/K7), ≤1e-3 cosine vs their f32 unfolded encoders, batch-128 encode
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
     A (K1, K2, K3 65, K5 195, stride block 195), its stored features within
     `INT8_COSINE_LIMITS`, every K2/K3/K5/stride-block call of one rollout encode held
     with phase 5's contracts. Iterations 0, 2
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
     195, stride block 195): the stored features equal to the encoder's output on the
     same frames, the
     encoder at batch 8 within `INT8_COSINE_LIMITS` on golden_frames(8), the stored
     features' distance to f32 printed beside the plain int8 graph's (the scripted
     controller's flat frames put both far from f32), and held within 1e-3 cosine
     (`INT8_PLAIN_GRAPH_LIMIT`) of the plain int8 graph fed by the same stem (K2) on the
     same frames, and of the plain graph with its own stem (whose stem convs keep their
     f32 outputs, as K2 and the JAX XLA graph do);
     every K2/K3/K5/stride-block call of one act-step encode held with phase 5's
     contracts; (d) a
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
 11. the CLIP transformer family at full width: (a) bf16 `clip_vit_b32` serves the
     four requests (key `clip_embed` (n, 512), finite bf16, K1 1 a request and no K6/K7),
     within 1e-3 cosine of its f32 encoder (TF32 off); `quantize(golden_frames(32))`
     serves them again, within 2e-2 of f32 (`VIT_INT8_COSINE_LIMIT`); batch-128 encode
     times of both, in turns, beside the arithmetic bound at the card's dense bf16 and
     int8 peaks; (b) `build_clip("RN50")` and `build_clip("ViT-B/32")` in f32 and bf16:
     the zero-shot goal table of the 12 RoboTHOR classes (`text_goal_table`,
     `DEFAULT_PROMPT`; (12, 1024) and (12, 512) of unit rows, bf16 within 1e-3 cosine of
     f32 row by row), the logits of golden_frames(8) against the 12 prompts ((8, 12),
     `logits_per_text` their transpose), the 12-prompt text encode timed; (c) zero-shot
     ObjectNav DD-PPO at phase 9's width (GridNav size 8, 56×56 frames, the 8 seen
     classes, 32 envs × 64 steps, hidden 512, 4 epochs, bf16 folded `clip_rn50` in the
     rollout, the goals through RN50's f32 table on the card by `_GoalMappedEnv`, the
     policy's `text_embed` goals) in a one-process NCCL group: 3 iterations (loss finite,
     weights changed, K1 = K7 = 65 and K6 = 650 launches each), every K6/K7 call of one
     rollout encode held with phase 7's contract and K1 at (32, 56, 56) → 224 held and
     timed, env-steps/s; then `evaluate_policy` on all 12 classes, 64 episodes, each
     recorded under its class name, success and SPL printed for the seen and the unseen
     split; (d) one batch-8 `clip_rn50x16` request (300×300 → 384), bf16 folded (K1 1,
     K7 1 over the 6-block stage 1, K6 31) within 1e-3 cosine of f32, every K6/K7 call
     held with phase 7's contract; then int8 path A (K1 1, stem12 1, K2 1, K5 3, stride
     block 3), every stem12/K2/K5/stride-block call held with phase 5's contracts, its
     distance to f32 printed;
 12. the RL experiment registry (`config.experiments.get_experiment`) at full width, each
     experiment as registered but for the overrides named: (a)
     `objectnav_robothor_rgb_clipresnet50gru_ddppo` (fake backend, bf16 folded
     `clip_rn50` in the rollout, 32 envs × 64 steps, hidden 512, 4 epochs; only
     `total_env_steps` and `ckpt_every_steps` overridden) with deterministic algorithms:
     3 iterations uninterrupted, and 2 iterations then a resume to 3 from the step
     checkpoint in a fresh output dir, the resumed weights bit-equal to the
     uninterrupted run's; launches per iteration K1 = K7 = 65, K6 = 650; env-steps/s
     and the checkpoint's size; (b) the same with `encoder_dtype=int8`, 1 iteration (K1,
     K2, K3 65, K5 195, stride block 195), calibrated on golden_frames(16) and 8 frames
     of the env, every K2/K3/K5/stride-block call of one rollout encode held with phase
     5's contracts; (c)
     `zeroshot_objectnav_robothor_rgb_clipresnet50gru_ddppo` trains 2 iterations, then
     `zeroshot_…_ddppo_eval` evaluates its checkpoint (`evaluate(ckpt=…)`) on 64 episodes
     over all 12 classes, metrics.json written and scored, seen and unseen success and
     SPL printed; (d) `ddppo_pointnav_rgb_clip` (2 epochs × 2 minibatches, linear LR
     decay) trains 2 iterations, its LR after the last update the schedule's; (e) the
     first experiment on the `thor` backend over the scripted controller (8 workers,
     horizon 40): 2 iterations, a resume to 3 that restores the optimizer state, then
     `evaluate` on the val scenes (16 episodes); every pool closed and the fork server
     stopped; (f) `one_phase_rgb_clipresnet50_dagger` trains 2 iterations;
 13. the probing stack (`check_probing`; cut to 600 frames of 4/2/2 scenes, see its
     docstring): (a) scene files in thor_frames.py's format (golden-frame textures at
     300×300, planted semantic patches, free space 0-13); (b) `extract-features` of
     imagenet_rn50 + clip_rn50 at batch 256 in f32, bf16 and int8 (`cli.main` in this
     process): keys, shapes, the planted labels, bf16 within 1e-3 cosine of f32, int8
     within `INT8_COSINE_LIMITS` / `IMAGENET_INT8_COSINE_LIMITS`, launches per batch (bf16
     K1 2; int8 K1 2, stem12 1, K2 1, K3 1, K5 3, stride block 3), every
     stem12/K2/K3/K5/stride-block call of one int8 batch held with
     phase 5's contracts, encode frames/s and the splits' encode / labels / npz-write
     seconds; (c) a 256-image reachability store read back by `load_probe_split`; (d)
     `probe-sweep --max-epochs 2` over the 11 probes (steps/s, epoch ms) and one probe
     per prediction type on the card against the CPU (val loss and test metric within
     1e-4); (e) `probe-train --eval --ckpt` reproduces the trained test metric, `train
     --config probe_… --eval` scores without training; (f) one probe at the reference's
     split sizes (6,000/750/750 frames), 5 epochs: ms a step, host ms a step, epoch ms
     (`--profile`: the device-busy share); (g) `verify-parity` on oracle checkpoints
     (clip_rn50, imagenet_rn18; f32, bf16, int8) with activations captured here, a
     subprocess run, a wrong checkpoint exiting 1, `convert-weights` feeding
     `--variables`; (h) `list-configs` in a subprocess; (i) with 2 cards, the
     data-parallel probe trainer in 2 NCCL processes against one;
 14. the JAX package's int8 graph options at full width (`bench.py:57-81`'s recipe:
     `clip_rn50` folded, `quantize(golden_frames(32))`, batch 128): (a) every K2-K5 and
     stride-block call of a path A and a path B encode in the reciprocal requant, held to
     its plain version in that form with phase 5's contracts and timed in both forms (ms
     and device_ms), the two forms' s8 outputs apart on ≤0.5% of elements (≤1 step where
     one requant makes the output), each kernel in that form where its TPU kernel calls
     `_unscale`, the stride block at all four requants; (b) batch-128 encodes in turns:
     path A, path A reciprocal, `int8_stem` "stem3" and "full" (their s8 stem convs
     through `conv3x3_int8`, each call held bit-exactly), path B reciprocal, the plain
     graph alone and with `int4_stage1` 1 and 2: ms, launches per encode (stem12 1 and
     K2 1 on paths A and B, neither under an int8 stem), cosine to f32 per key
     (INT8_COSINE_LIMITS; int4 INT4_COSINE_LIMIT);
     (c) ViT-B/32 int8:
     `quant_attn=False` (no farther from f32 than all-s8) and the reciprocal form, each
     timed and within VIT_INT8_COSINE_LIMIT; (d) `imagenet_rn50` int8 in both forms
     within IMAGENET_INT8_COSINE_LIMITS, beside its graph with bf16-rounded stem and
     shortcut convs (before they were repaired);
 15. the fused attention launch (`ops/kernels/attention_kernel.py`, `csrc/attention_bf16.cu`):
     held to its plain version (`attention_plain`) at ViT-L/14@336px's shapes (batch 8
     and 128, T = 577, 16 heads) and ViT-B/32's (batch 128, T = 50, 12 heads), each also
     beside the float64 softmax of the same bf16 inputs; timed at batch 128 against the
     plain attention path (`attention_core`) and its bound; then one batch-8
     `clip_vit_l14_336` bf16 encode (24 attention launches beside phase 16's, the
     attention's counters) against the f32 encoder of the same weights;
 16. the per-element launches of the ViT blocks (`ops/kernels/pointwise_kernel.py`,
     `csrc/pointwise_bf16.cu`): QuickGELU bit-exact to `quick_gelu` on all 65,536 bf16
     values and on hidden tensors of ViT-L/14@336px's and ViT-B/32's batch-128 shapes;
     the LayerNorm, alone and after the residual add, within
     `parity.layer_norm_step_disagreement`'s contract (one bf16 step on ≤0.1%) of
     `layer_norm_f32(x, ln).to(bf16)` at those shapes, the text tower's width 512 and
     ragged widths and rows, the sum bit-exact; each timed at ViT-L/14@336px's batch 128 beside its bytes bound and the plain chain,
     their sum over a batch-128 encode within 25 ms; a batch-128 `clip_vit_l14_336`
     encode with the launches and with the plain chains, in turns; the launches (49
     LayerNorm, 24 QuickGELU) and the `pw.*` counters of a batch-8 encode;
 17. check that no process the script started is left, then print {"kernels": [...]}
     (each K2-K5 and stride-block row with its reciprocal form's numbers and every
     kernel's launches per phase-14 encode; the stem12 and stride-block rows marked as
     having no TPU kernel) and the last line {"ok": true, "device": {...}}.

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

# Phase 12 (a) runs with deterministic algorithms, for which cuBLAS needs a fixed
# workspace configuration before its first call.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
# int8 ViT vs f32: the JAX package's own contract (tests/test_quantize_vit.py:27).
VIT_INT8_COSINE_LIMIT = 2e-2
# clip_rn50x16's K6 calls against float64 arithmetic (the same bf16 rounding points),
# stage by stage: the kernel differs on at most this many times the elements its plain
# version differs on over the stage's calls, and on no call on more than this many times
# the largest share the plain version shows at that stage. (A single call's ratio swings
# 0.4-1.8 from its content alone, whether cuDNN or the stride launches made its input,
# so it is no limit.)
EXACT_SHARE_RATIO = 1.5
STEP_LIMIT, STEP_SHARE_LIMIT = 1, 0.005  # K2, K3 vs plain (tests/test_stem_kernel.py:43)
# The kernels held at ≤STEP_LIMIT steps on ≤STEP_SHARE_LIMIT of elements (their f32 sums'
# order); of the stride block, o8 and cb3 (on the kernel's own o8 and id8) bit-exact, id8
# and the output within that contract (the plain graph's full-f32 shortcut product).
STEP_KERNELS = ("stem3_requant_pool_int8", "fused_stage1_int8", "fused_stride_block_int8")
# Launches per request on each int8 path (clip_rn50: 3 identity runs, 12 boundaries, 3
# stride blocks).
PER_REQUEST = {"A": {"fused_preprocess": 1, "stem12_f32": 1, "stem3_requant_pool_int8": 1,
                     "fused_stage1_int8": 1, "fused_resblocks_int8": 3,
                     "fused_cb3_cb1_int8": 0, "fused_stride_block_int8": 3},
               "B": {"fused_preprocess": 1, "stem12_f32": 1, "stem3_requant_pool_int8": 1,
                     "fused_stage1_int8": 1, "fused_resblocks_int8": 0,
                     "fused_cb3_cb1_int8": 12, "fused_stride_block_int8": 3}}
# Launches per request on the folded bf16 paths (RN50 trunks: stage 1, 3 + 5 + 2
# identity blocks; CLIP's three anti-aliased stride blocks on the bf16 launches,
# torchvision's on cuDNN; ResNet-18's basic blocks run no bottleneck kernel).
BF16_PER_REQUEST = {"clip_rn50": {"fused_preprocess": 1, "fused_stage1": 1,
                                  "fused_bottleneck": 10, "fused_stride_block_bf16": 3},
                    "imagenet_rn50": {"fused_preprocess": 1, "fused_stage1": 1,
                                      "fused_bottleneck": 10, "fused_stride_block_bf16": 0},
                    "imagenet_rn18": {"fused_preprocess": 1, "fused_stage1": 0,
                                      "fused_bottleneck": 0, "fused_stride_block_bf16": 0}}
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
    """(bytes, int8 ops, bf16 ops[, f32 ops]) one call of kernel `name` needs: each input
    and weight read once (an s8 weight once, not its K-major copy `*_t` beside it), each
    output written once; 2 operations per multiply-add. stem12's convs are f32 FMA."""
    if name == "stem12_f32":
        x, k1, b1, k2, b2 = args
        n, h1, w1, c = out.shape
        return (nbytes(x, out) + 9 * c * (3 + c) * 4 + 2 * c * 4, 0, 0,
                2 * n * h1 * w1 * c * (27 + 9 * c))
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
    if name == "fused_stride_block_int8":
        # cb1 (unless K4 made it: then q1 is read) and cb2 at the input's resolution, cb3
        # (unless K4 takes it) and the bf16 shortcut at the pooled one.
        x8, ops = args
        cb3, q1 = kw.get("cb3", True), kw.get("q1")
        m, mp = x8.numel() // x8.shape[-1], x8.numel() // x8.shape[-1] // 4
        keys = ["k2", "s2", "b2", "wsc", "bsc", "scl"]
        keys += (["k1", "s1", "b1"] if q1 is None else []) + (["k3", "s3", "b3"] if cb3 else [])
        macs8 = (m * ops["k1"].numel() if q1 is None else 0) + m * ops["k2"].numel() + (
            mp * ops["k3"].numel() if cb3 else 0)
        outs = out if isinstance(out, tuple) else (out,)
        return (nbytes(x8, *outs, *([q1] if q1 is not None else []), *(ops[k] for k in keys)),
                2 * macs8, 2 * mp * ops["wsc"].numel())
    raise KeyError(name)


def bf16_work(name: str, args, kw):
    """(bytes, 0, bf16 ops) one K6/K7 or bf16 stride-block call needs: x read once, the
    output written once, each weight and bias read once; 2 operations per multiply-add
    (the stride block's cb1 and cb2 at x's resolution, cb3 and the shortcut at the pooled
    one)."""
    x = args[0]
    m = x.numel() // x.shape[-1]
    if name == "fused_stride_block_bf16":
        n, h, w, _ = x.shape
        mp = n * (h // 2) * (w // 2)
        macs = (m * (kw["w1"].numel() + kw["w2"].numel())
                + mp * (kw["w3"].numel() + kw["wds"].numel()))
        return nbytes(x, *kw.values()) + mp * kw["w3"].shape[-1] * x.element_size(), 0, 2 * macs
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
    the operations at their type's dense peak (tensor cores; f32 on the CUDA cores)."""
    b, ops8, ops16, ops32 = (*work, 0)[:4]
    _, bw, f32, bf16, i8 = card
    bytes_ms, ops_ms = b / bw * 1e3, (ops8 / i8 + ops16 / bf16 + ops32 / f32) * 1e3
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
    """One recorded stem12, K2-K5, stride-block or `conv3x3_int8` call against its plain
    version on the same inputs: stem12 within `parity.stem12_step_disagreement`'s contract
    (≤STEM12_STEPS bf16 step, counted at no less than the output's RMS, on ≤STEM12_SHARE
    of the elements); K2 and K3 within STEP_LIMIT s8 steps on at most STEP_SHARE_LIMIT of
    the elements; K4, K5 and `conv3x3_int8` bit-exact, whatever their output's type; the
    stride block as `hold_stride_block` says. Returns (worst step, share of elements that
    differ)."""
    import torch

    from embodied_clip_tpu_torch.parity import (
        STEM12_SHARE,
        STEM12_STEPS,
        stem12_step_disagreement,
    )

    if name == "fused_stride_block_int8":
        return hold_stride_block(args, kw)
    fn, ref = getattr(mod, name), getattr(mod, name + "_reference")
    # K2's `wmat` and stem12's `ops` are the kernels' own copies of their weights, not
    # inputs of the kernels' functions.
    pkw = {k: v for k, v in kw.items() if k not in ("wmat", "ops")}
    before = fn.launches
    got = fn(*args, **kw)
    want = ref(*args, **pkw)
    torch.cuda.synchronize()
    check(fn.launches == before + 1, f"{name} launched its kernel")
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    worst_step, worst_share = 0, 0.0
    for g, w in pairs:
        check(g.shape == w.shape and g.dtype == w.dtype, f"{name} output shape/type")
        if name == "stem12_f32":
            share, step = stem12_step_disagreement(g, w)
            check(step <= STEM12_STEPS and share <= STEM12_SHARE,
                  f"stem12_f32 vs plain: {step} bf16 steps on {share:.2e} of elements")
            worst_step, worst_share = max(worst_step, step), max(worst_share, share)
            continue
        d = (g.float() - w.float()).abs()
        step, share = float(d.max()), float((d != 0).float().mean())
        if g.dtype == torch.int8:
            step = int(step)
        worst_step, worst_share = max(worst_step, step), max(worst_share, share)
        if name in ("stem3_requant_pool_int8", "fused_stage1_int8"):
            check(step <= STEP_LIMIT and share <= STEP_SHARE_LIMIT,
                  f"{name} vs plain: {step} steps on {share:.2e} of elements")
        else:
            check(torch.equal(g, w), f"{name} bit-exact vs its plain version on "
                                     f"{tuple(args[0].shape)}")
    return worst_step, worst_share


def hold_stride_block(args, kw):
    """One recorded stride-block call against its plain version on the same inputs
    (`parity.stride_block_disagreement`): o8 (cb1, cb2, the pools) bit-exact; id8 equal
    to the exact sum's requant, and within STEP_LIMIT steps on ≤STEP_SHARE_LIMIT of
    elements of the plain version's; with cb3, the output bit-exact
    against the plain cb3 of the kernel's own o8 and id8, and against the plain block
    within K3's contract (s8), or for the trunk's conv map apart on ≤STEP_SHARE_LIMIT of
    elements by at most r_res plus the bf16 rounding. Returns (worst s8 step, share of
    elements that differ) of id8 and an s8 output."""
    import torch

    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
    from embodied_clip_tpu_torch.parity import stride_block_disagreement

    x8, ops = args
    cb3, shape = kw.get("cb3", True), tuple(x8.shape)
    before = BK.fused_stride_block_int8.launches
    r = stride_block_disagreement(x8, ops, **kw)
    torch.cuda.synchronize()
    check(BK.fused_stride_block_int8.launches == before + (2 if cb3 else 1),
          "fused_stride_block_int8 launched its kernel")
    check(r["o8_equal"], f"stride block {shape}: o8 (cb1, cb2, the pools) bit-exact vs plain")
    check(r["id8_exact"], f"stride block {shape}: id8 equal to the exact sum's requant")
    step, share = r["id8_step"], r["id8_share"]
    check(step <= STEP_LIMIT and share <= STEP_SHARE_LIMIT,
          f"stride block {shape}: id8 vs plain {step} steps on {share:.2e} of elements")
    if not cb3:
        return step, share
    check(r["cb3_equal"], f"stride block {shape}: cb3 bit-exact vs plain on the kernel's "
                          f"own o8 and id8")
    g, w = r["out"], r["plain"]
    check(g.shape == w.shape and g.dtype == w.dtype, "fused_stride_block_int8 output shape/type")
    d = (g.float() - w.float()).abs()
    out_step, out_share = float(d.max()), float((d != 0).float().mean())
    if g.dtype == torch.int8:
        check(out_step <= STEP_LIMIT and out_share <= STEP_SHARE_LIMIT,
              f"stride block {shape} vs plain: {out_step} steps on {out_share:.2e}")
        return max(step, int(out_step)), max(share, out_share)
    limit = 1.01 * float(ops["scl"][3]) + 2 ** -7 * float(w.float().abs().max())
    check(out_share <= STEP_SHARE_LIMIT and out_step <= limit,
          f"stride block {shape}: conv map vs plain {out_step:.3e} (limit {limit:.3e}) on "
          f"{out_share:.2e} of elements")
    return step, share


def hold_bf16_call(name, args, kw, label):
    """One recorded K6/K7 call against its plain version on the same inputs
    (`parity.bf16_disagreement`; K7 block by block). Returns (kernel output, plain
    output, share differing, worst of the allowance, per-block pairs)."""
    import torch

    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
    from embodied_clip_tpu_torch.parity import (
        bf16_disagreement,
        bf16_share_limit,
        stage1_block_disagreements,
    )

    fn, ref = getattr(BK, name), getattr(BK, name + "_reference")
    limit = bf16_share_limit(args[1] if name == "fused_stage1" else [kw])
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
    check(all(s <= limit and w <= 1.0 for s, w in per_block),
          f"{label} {name} {tuple(args[0].shape)} vs plain: {share:.2e} differ (limit "
          f"{limit:.4f}), worst {worst:.3f}; per block {per_block}")
    return got, want, share, worst, per_block


def record_int8_calls(encoders, frames):
    """{kernel: {path: [(args, kw, out)]}} of every K2-K5 and stride-block call of one
    encode of each of `encoders` ({path: encoder})."""
    import contextlib

    import torch

    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
    from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK

    recs = {}
    for path, enc in encoders.items():
        with contextlib.ExitStack() as stack:
            rs = [stack.enter_context(Recorder(SK if name.startswith("stem") else BK, name))
                  for name in INT8_KERNELS]
            enc.encode(frames)
            torch.cuda.synchronize()
        for r in rs:
            if r.calls:
                recs.setdefault(r.name, {})[path] = r.calls
    return recs


# The int8 trunk's kernels of paths A and B, each with the path whose calls its row times.
INT8_KERNELS = {"stem12_f32": "A", "stem3_requant_pool_int8": "A",
                "fused_stage1_int8": "A", "fused_resblocks_int8": "A", "fused_cb3_cb1_int8": "B",
                "fused_stride_block_int8": "A"}


def check_int8_kernels(qenc, frames, card, profile):
    """Phase 5: every K2–K5 and stride-block call of a batch-128 encode on paths A and B,
    against the plain version on the same inputs; timings and bounds summed over one
    encode (the stride block's over path A's three calls, path B's held and timed too)."""
    import torch

    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
    from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK
    from embodied_clip_tpu_torch.ops.quantize import PATH_B

    recs = record_int8_calls({"A": qenc, "B": qenc.with_kernels(**PATH_B)}, frames)
    check(len(recs.get("fused_stride_block_int8", {}).get("B", [])) == 3,
          "path B's encode makes 3 stride-block calls")
    results = {}
    for name, path in INT8_KERNELS.items():
        mod = SK if name.startswith("stem") else BK
        fn, ref = getattr(mod, name), getattr(mod, name + "_reference")
        calls = recs.get(name, {}).get(path, [])
        check(len(calls) > 0, f"{name} ran on path {path}")
        worst_step, worst_share = 0, 0.0
        ms = device_ms = plain_ms = bound_ms = 0.0
        by = {"bytes": 0.0, "operations": 0.0}
        for args, kw, out in calls:
            step, share = hold_int8_call(mod, name, args, kw)
            worst_step, worst_share = max(worst_step, step), max(worst_share, share)
            pkw = {k: v for k, v in kw.items() if k not in ("wmat", "ops")}
            k_ms = cuda_ms(lambda: fn(*args, **kw), 10)
            d_ms = graph_ms(lambda: fn(*args, **kw))
            p_ms = cuda_ms(lambda: ref(*args, **pkw), 3, warmup=1)
            work = int8_work(name, args, kw, out)
            b_ms, b_by = bound(work, card)
            ms, device_ms = ms + k_ms, device_ms + d_ms
            plain_ms, bound_ms = plain_ms + p_ms, bound_ms + b_ms
            by[b_by] += b_ms
            tops = sum(work[1:]) / k_ms / 1e9
            print(f"[5] {name} {tuple(args[0].shape)}: kernel {k_ms:.4f} ms ({tops:.1f} "
                  f"TOP/s, {b_ms / k_ms:.1%} of the bound; {d_ms:.4f} ms on the device, "
                  f"replayed from a CUDA graph), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"by {b_by}")
        contract = (f"≤{STEP_LIMIT} step on ≤{STEP_SHARE_LIMIT:g}: worst {worst_step} step "
                    f"on {worst_share:.2e}" if name in STEP_KERNELS else "bit-exact")
        if name == "fused_stride_block_int8":
            contract = f"o8 and cb3 bit-exact, id8 and the output {contract}"
        if name == "stem12_f32":
            contract = (f"≤1 bf16 step (at no less than the RMS) on ≤0.1%: worst "
                        f"{worst_step} on {worst_share:.2e}")
        print(f"[5] {name}: {len(calls)} call(s) per batch-128 encode (path {path}): kernel "
              f"{ms:.4f} ms ({device_ms:.4f} ms on the device, from CUDA graphs), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms; {contract}")
        results[name] = {"max_abs_err": float(worst_step), "share_differing": worst_share,
                         "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": max(by, key=by.get)}
    # Path B's stride-block calls (cb3 left to K4; cb1 from K4 in stages 3 and 4).
    b_calls = recs["fused_stride_block_int8"]["B"]
    b = {"ms": 0.0, "bound_ms": 0.0, "worst_step": 0, "share_differing": 0.0}
    for args, kw, out in b_calls:
        step, share = hold_int8_call(BK, "fused_stride_block_int8", args, kw)
        b["worst_step"], b["share_differing"] = (max(b["worst_step"], step),
                                                 max(b["share_differing"], share))
        b["ms"] += cuda_ms(lambda: BK.fused_stride_block_int8(*args, **kw), 10)
        b["bound_ms"] += bound(int8_work("fused_stride_block_int8", args, kw, out), card)[0]
    print(f"[5] fused_stride_block_int8, path B (o8 and id8 for K4; cb1 from K4 in stages 3 "
          f"and 4): {len(b_calls)} calls held (o8 bit-exact, id8 worst {b['worst_step']} step "
          f"on {b['share_differing']:.2e}), kernel {b['ms']:.4f} ms, bound {b['bound_ms']:.4f} ms")
    results["fused_stride_block_int8"]["path_b"] = b
    first = {name: paths[INT8_KERNELS[name]] for name, paths in recs.items()}
    results["stem3_requant_pool_int8"].update(stem_yardstick(first))
    results["stem12_f32"].update(stem12_library(first))
    results["fused_stage1_int8"].update(stage1_entry(first, card))
    results["fused_stride_block_int8"].update(stride_block_parts(first, card))
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


def stem12_library(recs):
    """Phase 5: cuDNN's two f32 convs of stem12's shapes (full f32, as the int8 graph's
    plain route calls them, on inputs made beforehand: no casts, bias or ReLU passes),
    timed as stem12 is: the library's share of the route stem12 replaced (`library_ms`)."""
    import torch
    import torch.nn.functional as F

    from embodied_clip_tpu_torch.ops.int8 import full_f32

    (x, k1, _, k2, _), _, out = recs["stem12_f32"][0]
    w1 = k1.to(torch.bfloat16).float().permute(3, 2, 0, 1).contiguous()
    w2 = k2.to(torch.bfloat16).float().permute(3, 2, 0, 1).contiguous()
    xf, tf = x.float(), out.float()

    def convs():
        with full_f32():
            F.conv2d(xf.permute(0, 3, 1, 2), w1, None, 2, 1)
            F.conv2d(tf.permute(0, 3, 1, 2), w2, None, 1, 1)

    ms = cuda_ms(convs, 10)
    print(f"[5] beside stem12: cuDNN's f32 stem1 + stem2 convs {tuple(x.shape)} → "
          f"{tuple(out.shape)} (full f32, the convs alone) {ms:.4f} ms")
    return {"library_ms": ms, "library": "cuDNN f32 stem1 + stem2 convs, full f32, alone"}


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


def stride_block_parts(recs, card):
    """Phase 5: each of path A's stride-block calls launch by launch, each launch on the
    inputs the one before it wrote: (f') (the pool + scale of the block input) bit-equal
    to its plain version, the shortcut (e)'s id8 equal to the exact sum's requant
    (`_shortcut_reference`) and against the plain graph's full-f32 product (the share
    apart is reported), the share it flagged as near-ties; each launch kind timed alone
    against its bound (`ms` by CUDA events around back-to-back calls; (e) and (f') also
    `device_ms`, replayed from a CUDA graph). Beside the block, its products alone
    through the library's route, which the port never calls on this path:
    `torch._int_mm` for cb1 and cb3, im2col + `torch._int_mm` for cb2
    (`ops/int8.qconv_acc`), `torch.matmul` of the bf16 shortcut (f32 out, no requant).
    (Every launch of both paths against its bound: `tools/bench_int8_gemm.py`.)"""
    import torch

    from embodied_clip_tpu_torch.ops.int8 import avg_pool_int8, qconv_acc, qmm
    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK

    bits = torch.tensor([bin(i).count("1") for i in range(256)], device="cuda")
    library_ms, flagged, apart, exact, pool_equal = 0.0, [], [], True, True
    kinds, stages = {}, []
    for args, kw, _ in recs["fused_stride_block_int8"]:
        x8, ops = args
        recip, scl = kw.get("recip", False), ops["scl"]
        n, h, w, cin = x8.shape
        cm, cout = ops["k2"].shape[-1], ops["wsc"].shape[-1]
        m, mp = n * h * w, n * (h // 2) * (w // 2)

        def s8(shape):
            return torch.empty(shape, dtype=torch.int8, device="cuda")

        q1, q2, out = s8((n, h, w, cm)), s8((n, h, w, cm)), s8((n, h // 2, w // 2, cout))
        k1t, k2t, k3t = (BK._kmajor_copy(ops, k) for k in ("k1", "k2", "k3"))
        b = BK._ptr
        parts = {}  # kind: (launch, (bytes, s8 ops, bf16 ops))

        def cb1():
            BK._conv1x1(x8, k1t, ops["s1"], ops["b1"], b(scl, 1), q1, recip=recip)

        def cb2():
            BK._conv3x3(q1, k2t, ops["s2"], ops["b2"], b(scl, 2), q2, recip=recip)

        cb1()
        cb2()
        o8 = BK._avg_pool2(q2)
        x0, rnorm = BK._pool2_scale(x8, b(scl, 0))
        sc8, ties = BK._shortcut(x0, rnorm, ops, b(scl, 3), recip)

        def cb3():
            BK._conv1x1(o8, k3t, ops["s3"], ops["b3"], b(scl, 4), out, res=sc8,
                        r_res_ptr=b(scl, 3), recip=recip)

        vec = 4 * 2  # a scale and a bias, f32
        parts["(a) cb1"] = (cb1, (m * cin + cin * cm + vec * cm + m * cm, 2 * m * cin * cm, 0))
        parts["(b) cb2"] = (cb2, (2 * m * cm + 9 * cm * cm + vec * cm, 2 * m * 9 * cm * cm, 0))
        parts["(f) pool"] = (lambda: BK._avg_pool2(q2), (m * cm + mp * cm, 0, 0))
        parts["(f') pool + scale"] = (lambda: BK._pool2_scale(x8, b(scl, 0)),
                                      (m * cin + 2 * mp * cin + 4 * mp, 0, 0))
        parts["(e) shortcut"] = (lambda: BK._shortcut(x0, rnorm, ops, b(scl, 3), recip),
                                 (2 * mp * cin + 4 * mp + 2 * cin * cout + vec * cout
                                  + mp * cout, 0, 2 * mp * cin * cout))
        parts["(a) cb3"] = (cb3, (2 * mp * cm + cm * cout + vec * cout + 2 * mp * cout,
                                  2 * mp * cm * cout, 0))
        want_x0, want_rnorm = BK.pool2_scale_reference(x8, scl[0])
        want = BK._shortcut_reference(avg_pool_int8(x8, 2), ops["wsc"], ops["bsc"], scl[0],
                                      scl[3], recip)
        plain = BK._stride_shortcut_reference(avg_pool_int8(x8, 2), ops["wsc"], ops["bsc"],
                                              scl[0], scl[3], recip)
        torch.cuda.synchronize()
        pool_equal &= torch.equal(x0, want_x0) and torch.equal(rnorm, want_rnorm)
        exact &= torch.equal(sc8, want)
        apart.append(float((sc8 != plain).float().mean()))
        flagged.append(int(bits[ties.view(torch.uint8).long()].sum()) / sc8.numel())
        stage = {"x": list(x8.shape), "shortcut_flagged": flagged[-1]}
        for kind, (fn, work) in parts.items():
            k_ms = cuda_ms(fn, 10)
            b_ms, b_by = bound(work, card)
            row = kinds.setdefault(kind, {"ms": 0.0, "bound_ms": 0.0, "launches": 0})
            row["ms"] += k_ms
            row["bound_ms"] += b_ms
            row["launches"] += 1
            row["bound_by"] = b_by
            stage[kind] = {"ms": k_ms, "bound_ms": b_ms, "bound_by": b_by}
            if kind.startswith(("(e)", "(f')")):
                d_ms = graph_ms(fn)
                stage[kind]["device_ms"] = d_ms
                row["device_ms"] = row.get("device_ms", 0.0) + d_ms
                print(f"[5] stride block {tuple(x8.shape)} {kind}: {k_ms:.4f} ms ({d_ms:.4f} "
                      f"ms on the device), {b_ms / k_ms:.1%} of its bound {b_ms:.4f} ms by "
                      f"{b_by} ({b_ms / d_ms:.1%} on the device)")
        stages.append(stage)
        a16 = (avg_pool_int8(x8, 2).reshape(-1, cin).float() * scl[0]).to(torch.bfloat16)
        library_ms += (cuda_ms(lambda: qmm(x8.reshape(-1, cin), ops["k1"]), 10)
                       + cuda_ms(lambda: qconv_acc(q1, ops["k2"]), 5)
                       + cuda_ms(lambda: qmm(o8.reshape(-1, cm), ops["k3"]), 10)
                       + cuda_ms(lambda: torch.matmul(a16, ops["wsc"]), 10))
        print(f"[5] stride block {tuple(x8.shape)}: (f') bit-equal to its plain version: "
              f"{torch.equal(x0, want_x0) and torch.equal(rnorm, want_rnorm)}; the shortcut "
              f"flagged {flagged[-1]:.3e} of id8 as near-ties; id8 equal to the exact sum's "
              f"requant: {torch.equal(sc8, want)}; apart from the plain graph's full-f32 "
              f"product on {apart[-1]:.3e}")
    check(pool_equal, "the stride blocks' pool + scale (f') bit-equal to its plain version")
    check(exact, "the stride shortcut's id8 equals the exact sum's requant on every element")
    for kind, row in kinds.items():
        print(f"[5] the stride blocks' {kind} launches: {row['ms']:.4f} ms over "
              f"{row['launches']} against bounds of {row['bound_ms']:.4f} ms "
              f"({row['bound_ms'] / row['ms']:.1%})"
              + (f"; {row['device_ms']:.4f} ms on the device" if "device_ms" in row else ""))
    print(f"[5] the stride blocks' products alone through the library's route "
          f"(torch._int_mm, im2col + torch._int_mm, torch.matmul bf16): {library_ms:.4f} ms")
    return {"library_ms": library_ms,
            "library_route": "the block's products alone: torch._int_mm (cb1, cb3), im2col + "
                             "torch._int_mm (cb2), torch.matmul of bf16 (the shortcut)",
            "shortcut_flagged": flagged, "id8_apart_from_plain_f32": apart,
            "launch_kinds": kinds, "per_block": stages}


# The bf16 wrappers and the step of the fused plan (models/stages.py) each one runs.
BF16_STEPS = {"fused_stage1": "stage1", "fused_bottleneck": "bottleneck",
              "fused_stride_block_bf16": "stride"}


def check_bf16_kernels(encoders, frames, card):
    """Phase 7: every K6/K7 and bf16 stride-block call of a batch-128 encode of each
    encoder in `encoders` ({label: folded bf16 encoder}) against its plain version;
    timings, bounds and the cuDNN route's time of the same block(s), summed over one
    encode; clip_rn50's stride blocks also launch by launch (`bf16_stride_parts`)."""
    import contextlib

    import torch

    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK

    results = {}
    for label, enc in encoders.items():
        with contextlib.ExitStack() as stack:
            recs = {name: stack.enter_context(Recorder(BK, name)) for name in BF16_STEPS}
            enc.encode(frames)
            torch.cuda.synchronize()
        plan = enc.module.fused_plan()
        calls = []
        for name, kind in BF16_STEPS.items():
            steps = [mod for k, mod in plan if k == kind]
            check(len(recs[name].calls) == len(steps),
                  f"{label}: {len(recs[name].calls)} {name} calls match its plan's "
                  f"{len(steps)} {kind} steps")
            calls += [(name, c, mod) for c, mod in zip(recs[name].calls, steps)]
        check(len(recs["fused_stage1"].calls) == 1, f"{label}: one K7 call")
        if label == "clip_rn50":
            results["stride_parts"] = bf16_stride_parts(recs["fused_stride_block_bf16"].calls,
                                                        card)
        for name, (args, kw, out), mod in calls:
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
        if name == "stride_parts":
            continue
        per_enc = {lab: sum(c["ms"] for c in calls) for lab, calls in r["calls"].items()}
        print(f"[7] {name}: per batch-128 encode (kernel ms) {per_enc}; clip_rn50: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, cuDNN route "
              f"{r['cudnn_route_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")
    return results


def bf16_stride_parts(calls, card):
    """Phase 7: each of clip_rn50's bf16 stride-block calls launch by launch, each launch
    on the inputs the one before it wrote: P's pools bit-equal to `F.avg_pool2d` (on the
    NCHW channels-last views the module route pools) and to their plain version, (c)
    against the plain (c) of the launches' own p and xp (`parity.bf16_disagreement`);
    each launch kind timed alone against its bound (`ms` by CUDA events around
    back-to-back calls, P also `device_ms` from a CUDA-graph replay), and P beside
    `F.avg_pool2d` of the same two tensors."""
    import torch
    import torch.nn.functional as F

    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
    from embodied_clip_tpu_torch.parity import BF16_KERNEL_SHARE, bf16_disagreement

    kinds, stages, pools_equal, library_ms = {}, [], True, 0.0
    for (x,), ops, _ in calls:
        n, h, w, cin = x.shape
        cm, cout = ops["w1"].shape[-1], ops["w3"].shape[-1]
        m, mp = n * h * w, n * (h // 2) * (w // 2)
        h1 = torch.empty((n, h, w, cm), dtype=x.dtype, device=x.device)
        h2 = torch.empty_like(h1)
        out = torch.empty((n, h // 2, w // 2, cout), dtype=x.dtype, device=x.device)

        def a():
            BK._gemm(x, ops["w1"], ops["b1"], h1)

        def b():
            BK._gemm(h1, ops["w2"], ops["b2"], h2, conv3=True)

        a()
        b()
        p, xp = BK._avg_pool2_pair(h2, x)

        def c():
            BK._gemm(p, ops["w3"], ops["b3"], out, a2=xp, w2=ops["wds"], bias2=ops["bds"])

        c()
        torch.cuda.synchronize()
        bits = [t.view(torch.int16) for t in (
            p, xp, BK.avg_pool2_bf16_reference(h2), BK.avg_pool2_bf16_reference(x),
            F.avg_pool2d(h2.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1),
            F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1))]
        equal = all(torch.equal(bits[i], bits[i + 2]) and torch.equal(bits[i], bits[i + 4])
                    for i in (0, 1))
        pools_equal &= equal
        want = BK.pooled_cb3_reference(p, xp, ops["w3"], ops["b3"], ops["wds"], ops["bds"])
        c_share, c_worst = bf16_disagreement(out, want)
        work = {"(a)": (a, (2 * (m * cin + cin * cm + m * cm) + 4 * cm, 0, 2 * m * cin * cm)),
                "(b)": (b, (2 * (2 * m * cm + 9 * cm * cm) + 4 * cm, 0, 2 * m * 9 * cm * cm)),
                "P": (lambda: BK._avg_pool2_pair(h2, x), (2 * 5 * mp * (cm + cin), 0, 0)),
                "(c)": (c, (2 * (mp * (cm + cin) + (cm + cin) * cout + mp * cout) + 8 * cout,
                            0, 2 * mp * (cm + cin) * cout))}
        stage = {"x": list(x.shape), "pools_bit_equal": equal, "c_share_differing": c_share,
                 "c_worst_of_allowance": c_worst}
        line = []
        for kind, (fn, wk) in work.items():
            k_ms = cuda_ms(fn, 10)
            b_ms, b_by = bound(wk, card)
            row = kinds.setdefault(kind, {"ms": 0.0, "bound_ms": 0.0, "launches": 0})
            row["ms"] += k_ms
            row["bound_ms"] += b_ms
            row["launches"] += 1
            stage[kind] = {"ms": k_ms, "bound_ms": b_ms, "bound_by": b_by}
            if kind == "P":
                d_ms = graph_ms(fn)
                stage[kind]["device_ms"] = d_ms
                row["device_ms"] = row.get("device_ms", 0.0) + d_ms
            line.append(f"{kind} {k_ms:.4f} ms ({b_ms / k_ms:.1%} of {b_ms:.4f} by {b_by})")
        h2c, xc = h2.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2)
        lib = cuda_ms(lambda: (F.avg_pool2d(h2c, 2), F.avg_pool2d(xc, 2)), 10)
        library_ms += lib
        stage["avg_pool2d_ms"] = lib
        stages.append(stage)
        print(f"[7] bf16 stride block {tuple(x.shape)}: " + " / ".join(line)
              + f"; P's pools bit-equal to avg_pool2d and the plain version: {equal}; "
              f"F.avg_pool2d of h2 and x {lib:.4f} ms; (c) vs plain on its own p, xp: "
              f"{c_share:.2e} differ, worst {c_worst:.3f}")
        check(c_share <= BF16_KERNEL_SHARE and c_worst <= 1.0,
              f"bf16 stride block {tuple(x.shape)} (c) vs plain")
    check(pools_equal, "P's pools bit-equal to F.avg_pool2d and to their plain version")
    for kind, row in kinds.items():
        print(f"[7] the bf16 stride blocks' {kind} launches: {row['ms']:.4f} ms over "
              f"{row['launches']} against bounds of {row['bound_ms']:.4f} ms "
              f"({row['bound_ms'] / row['ms']:.1%})"
              + (f"; {row['device_ms']:.4f} ms on the device" if "device_ms" in row else ""))
    print(f"[7] F.avg_pool2d of the same tensors (the module route's pools): {library_ms:.4f} ms")
    return {"launch_kinds": kinds, "per_block": stages, "avg_pool2d_ms": library_ms}


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


def hold_rollout_calls(fe, frames, label, phase="9", per_encode=None):
    """Phases 9-11: every K2-K7 call of one encode (a rollout's own frames: batch-32
    56×56 in phases 9 and 11, batch-8 300×300 in phase 10; RN50x16's request in phase
    11) against its plain version on the same inputs, with phase 5's and phase 7's
    contracts. `per_encode` gives the calls an encode makes (default: `clip_rn50`'s).
    Returns {kernel: {calls, worst, share}}."""
    import contextlib

    import torch

    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
    from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK

    per_encode = per_encode or {
        "bf16": {"fused_stage1": 1, "fused_bottleneck": 10, "fused_stride_block_bf16": 3},
        "int8": {k: v for k, v in PER_REQUEST["A"].items()
                 if v and k != "fused_preprocess"}}[label]
    modules = {"stem12_f32": SK, "stem3_requant_pool_int8": SK}
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
            contract = ("≤1% of elements differ (more past RN50's longest reduction: "
                        "parity.bf16_share_limit), each within 2 bf16 steps" if label == "bf16"
                        else "≤1 bf16 step (at no less than the RMS) on ≤0.1%"
                        if r.name == "stem12_f32"
                        else f"≤{STEP_LIMIT} step on ≤{STEP_SHARE_LIMIT:g}"
                        if r.name in STEP_KERNELS else "bit-exact")
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
    counted = counted_kernels()
    want = {"bf16": {"fused_preprocess": 1, "fused_stage1": 1, "fused_bottleneck": 10,
                     "fused_stride_block_bf16": 3},
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

    counted = counted_kernels()
    per_encode = {"bf16": {"fused_preprocess": 1, "fused_stage1": 1, "fused_bottleneck": 10,
                           "fused_stride_block_bf16": 3},
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
        # their chaining fails the run; and against the plain graph with its own stem,
        # whose stem convs keep their f32 outputs unrounded, as K2 and the JAX XLA graph
        # do (on flat frames a requant flipped by a rounding flips whole regions).
        ref8 = f32.encode(frames8)["clip_conv"]
        plain = fe8.encoder.with_kernels(**KERNELS_OFF).encode(frames8)["clip_conv"]
        zero_counts()
        k2_plain = fe8.encoder.with_kernels(**{**KERNELS_OFF, "kernel_stem": True}).encode(
            frames8)["clip_conv"]
        torch.cuda.synchronize()
        check({k: fn.launches for k, fn in counted.items() if fn.launches}
              == {"fused_preprocess": 1, "stem12_f32": 1, "stem3_requant_pool_int8": 1},
              "(c) the plain graph fed by stem12 and K2 launches K1, stem12 and K2 alone")
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
        check(cos_env["path_a_vs_plain_graph"] <= INT8_PLAIN_GRAPH_LIMIT,
              f"(c) the stored features within {INT8_PLAIN_GRAPH_LIMIT:g} of the plain int8 "
              "graph with its own stem on the act step's frames")
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


def vit_work(name: str, n: int):
    """(operations of the four s8-able denses, all other operations) of one `name` ViT
    request of n frames, 2 per multiply-add: the blocks' in-proj, out-proj and MLP; the
    patch embed, the attention products and the projection."""
    from embodied_clip_tpu_torch.models.clip_vit import CLIP_VIT_CONFIGS

    cfg = CLIP_VIT_CONFIGS[name]
    w, layers, p = cfg["width"], cfg["layers"], cfg["patch_size"]
    grid = (cfg["image_size"] // p) ** 2
    t = grid + 1
    dense = 2 * n * t * layers * 12 * w * w
    other = 2 * n * (layers * 2 * t * t * w + grid * p * p * 3 * w + w * cfg["output_dim"])
    return dense, other


def counted_kernels():
    """{name: wrapper} of every kernel whose launches the script counts."""
    from embodied_clip_tpu_torch.ops.kernels import attention_kernel as AK
    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
    from embodied_clip_tpu_torch.ops.kernels import pointwise_kernel as PK
    from embodied_clip_tpu_torch.ops.kernels import preprocess_kernel as K
    from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK

    return {"fused_preprocess": K.fused_preprocess, "fused_stage1": BK.fused_stage1,
            "attention_bf16": AK.attention_bf16, "layer_norm_bf16": PK.layer_norm_bf16,
            "quick_gelu_bf16": PK.quick_gelu_bf16,
            "fused_bottleneck": BK.fused_bottleneck,
            "fused_stride_block_bf16": BK.fused_stride_block_bf16,
            "stem12_f32": SK.stem12_f32,
            "stem3_requant_pool_int8": SK.stem3_requant_pool_int8,
            "fused_stage1_int8": BK.fused_stage1_int8,
            "fused_resblocks_int8": BK.fused_resblocks_int8,
            "fused_cb3_cb1_int8": BK.fused_cb3_cb1_int8,
            "fused_stride_block_int8": BK.fused_stride_block_int8,
            "conv3x3_int8": BK.conv3x3_int8}


def library_s8_calls(fn):
    """{"qmm": n, "im2col3x3": n}: the calls fn() makes of `ops/int8.qmm`
    (`torch._int_mm`) and `ops/int8.im2col3x3`, through any module of the port that
    holds them."""
    from embodied_clip_tpu_torch.ops import int8 as I8

    counts = {"qmm": 0, "im2col3x3": 0}
    originals = {name: getattr(I8, name) for name in counts}
    patched = []
    for mod in [m for k, m in sys.modules.items() if k.startswith("embodied_clip_tpu_torch")]:
        for name in counts:
            if getattr(mod, name, None) is originals[name]:
                def counting(*a, _fn=originals[name], _name=name, **k):
                    counts[_name] += 1
                    return _fn(*a, **k)
                patched.append((mod, name, getattr(mod, name)))
                setattr(mod, name, counting)
    try:
        fn()
    finally:
        for mod, name, orig in patched:
            setattr(mod, name, orig)
    return counts


def launches_of(fn):
    """(fn's result, {kernel: launches during fn()}, only the nonzero counts): every
    count is set to 0 just before and read just after."""
    import torch

    counted = counted_kernels()
    for k in counted.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: f.launches for k, f in counted.items() if f.launches}


def check_vit(card, smi, reqs, x128):
    """Phase 11 (a): ViT-B/32 serving in bf16 and int8."""
    import torch

    from embodied_clip_tpu_torch.models.encoders import build_encoder
    from embodied_clip_tpu_torch.ops.int8 import full_f32
    from embodied_clip_tpu_torch.parity import cosine_distance, golden_frames

    g8 = golden_frames(8)
    vit = build_encoder("clip_vit_b32", dtype=torch.bfloat16, device="cuda")
    with full_f32():
        ref = build_encoder("clip_vit_b32", dtype=torch.float32, device="cuda").encode(g8)
    out = {"cosine_vs_f32": {}, "launches_per_request": {}, "encode_ms_batch128": {}}

    def serve(enc, label):
        t0 = time.perf_counter()
        outs, got = launches_of(lambda: [enc.encode(f) for f in reqs])
        serve_s = time.perf_counter() - t0
        for (n, _), o in zip(REQUESTS, outs):
            check(set(o) == {"clip_embed"} and tuple(o["clip_embed"].shape) == (n, 512)
                  and o["clip_embed"].dtype == torch.bfloat16
                  and bool(torch.isfinite(o["clip_embed"].float()).all()),
                  f"clip_vit_b32 {label} response for batch {n}")
        want = {"fused_preprocess": len(REQUESTS)}
        if label == "bf16":  # the int8 tower keeps attention_core and the plain chains
            want.update({k: v * len(REQUESTS) for k, v in vit_pointwise_launches(12).items()})
        check(got == want, f"clip_vit_b32 {label} launches {got}, expected {want}")
        out["launches_per_request"][label] = {k: v // len(REQUESTS) for k, v in got.items()}
        cos = cosine_distance(enc.encode(g8)["clip_embed"], ref["clip_embed"])
        out["cosine_vs_f32"][label] = cos
        limit = COSINE_LIMIT if label == "bf16" else VIT_INT8_COSINE_LIMIT
        print(f"[11a] clip_vit_b32 {label}: {len(REQUESTS)} requests (batches "
              f"{', '.join(f'{n} {lay}' for n, lay in REQUESTS)}, first call included) in "
              f"{serve_s:.3f} s: key clip_embed (n, 512), finite bf16; launches {got}; "
              f"clip_embed vs the f32 encoder (TF32 off) on golden_frames(8): cosine "
              f"{cos:.3e} (limit {limit:g})")
        check(cos <= limit, f"clip_vit_b32 {label} within {limit:g} cosine of f32")

    serve(vit, "bf16")
    t0 = time.perf_counter()
    qvit = vit.quantize(golden_frames(32))
    torch.cuda.synchronize()
    print(f"[11a] clip_vit_b32 quantized (calibrated on golden_frames(32)) in "
          f"{time.perf_counter() - t0:.2f} s")
    serve(qvit, "int8")
    dense, other = vit_work("ViT-B/32", 128)
    _, _, _, bf16_peak, i8_peak = card
    bound = {"bf16": (dense + other) / bf16_peak * 1e3,
             "int8": (dense / i8_peak + other / bf16_peak) * 1e3}
    times = {}
    for label in ("bf16", "int8", "int8", "bf16"):  # in turns
        enc = vit if label == "bf16" else qvit
        times.setdefault(label, []).append(cuda_ms(lambda: enc.encode(x128), 10))
    for label, ms in times.items():
        out["encode_ms_batch128"][label] = min(ms)
        print(f"[11a] clip_vit_b32 {label} encode, batch 128 on the device: "
              f"{', '.join(f'{m:.3f}' for m in ms)} ms ({128 / min(ms) * 1e3:.1f} frames/s); "
              f"arithmetic bound {bound[label]:.3f} ms ({(dense + other) / 1e12:.3f} TFLOP: "
              f"{dense / 1e12:.3f} in the denses at the {label} peak, the rest at bf16's; "
              f"{bound[label] / min(ms):.1%} of it); {smi}")
    out["bound_ms_batch128"] = bound
    out["tflop_batch128"] = (dense + other) / 1e12
    return out


def vit_pointwise_launches(layers: int) -> dict:
    """Launches of one bf16 ViT encode of `layers` blocks: the attention, ln_1 and ln_2
    (with the residual add) a block and ln_pre, QuickGELU a block."""
    return {"attention_bf16": layers, "layer_norm_bf16": 2 * layers + 1,
            "quick_gelu_bf16": layers}


def attention_row_gap(a, b):
    """The largest relative L2 gap of a row (one token of one frame) of `a` from `b`."""
    a, b = a.double(), b.double()
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).max())


def attention_exact(qkv, heads):
    """softmax(q kᵀ / √64) v in float64 of the bf16 inputs, (N, T, C)."""
    n, t, c3 = qkv.shape
    c = c3 // 3
    q, k, v = (x.reshape(n, t, heads, 64).transpose(1, 2).double() for x in qkv.split(c, -1))
    out = ((q @ k.transpose(-1, -2)) / 8.0).softmax(dim=-1) @ v
    return out.transpose(1, 2).reshape(n, t, c)


def attention_inputs(n, t, heads, seed):
    """Seeded (N, T, 3C) bf16 in-projection outputs whose logits spread as a trained
    ViT's do (q and k of std 1.7: logits of std ~2.9), v of unit scale."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = 64 * heads
    x = torch.randn((n, t, 3 * c), generator=gen, device="cuda")
    x[..., :2 * c] *= 1.7
    return x.to(torch.bfloat16)


# The kernel against its plain version: the same roundings, apart from the exponential
# (ex2.approx against torch.exp, a few f32 ulps, which can flip a bf16 probability by one
# step) and the f32 sums' order; so a row may differ by a bf16 step on a few elements.
# 2^-8, one bf16 step on every element of a row, is the limit.
ATTENTION_ROW_LIMIT = 2.0 ** -8


def check_attention(card, smi):
    """Phase 15: the fused attention launch at the ViTs' shapes against its plain
    version, its time at batch 128 beside the plain attention path and its bound, and a
    batch-8 ViT-L/14@336px bf16 encode."""
    import torch

    from embodied_clip_tpu_torch.models.encoders import build_encoder
    from embodied_clip_tpu_torch.models.transformer import attention_core
    from embodied_clip_tpu_torch.ops.int8 import full_f32
    from embodied_clip_tpu_torch.ops.kernels import attention_kernel as AK
    from embodied_clip_tpu_torch.parity import cosine_distance, golden_frames
    from embodied_clip_tpu_torch.utils import profiling

    _, mem_bps, _, bf16_peak, _ = card
    out = {"held": {}, "times": {}}
    for n, t, heads in ((8, 577, 16), (128, 577, 16), (128, 50, 12), (3, 17, 4)):
        qkv = attention_inputs(n, t, heads, seed=n * 1000 + t)
        AK.attention_bf16.launches = 0
        got = AK.attention_bf16(qkv, heads)
        torch.cuda.synchronize()
        plain = AK.attention_plain(qkv, heads)
        gap = attention_row_gap(got, plain.float())
        exact = {}
        if n * t <= 8 * 577:   # the float64 logits of batch 128 would take 11 GB
            e = attention_exact(qkv, heads)
            exact = {"kernel": attention_row_gap(got, e), "plain": attention_row_gap(plain, e)}
        flips = float((got != plain).float().mean())
        out["held"][f"{n}x{t}x{heads}"] = {"row_gap": gap, "differing": flips, **{
            f"exact_gap_{k}": v for k, v in exact.items()}}
        print(f"[15] attention ({n}, {t}, {heads} heads): kernel vs attention_plain, largest "
              f"row gap {gap:.3e} (limit {ATTENTION_ROW_LIMIT:.3e}), {flips:.3%} of elements "
              f"differ" + (f"; vs the float64 softmax: kernel {exact['kernel']:.3e}, plain "
                           f"{exact['plain']:.3e}" if exact else "") +
              f"; {AK.attention_bf16.launches} launch")
        check(AK.attention_bf16.launches == 1 and gap <= ATTENTION_ROW_LIMIT,
              f"attention kernel within {ATTENTION_ROW_LIMIT:g} of its plain version at "
              f"({n}, {t}, {heads})")
        if exact:
            check(exact["kernel"] <= 1.25 * exact["plain"] + 1e-4,
                  "the kernel no farther from the float64 softmax than its plain version")
        if n == 128:
            c = 64 * heads
            q, k, v = qkv.chunk(3, dim=-1)
            ops = 4.0 * n * t * t * c
            nbytes = 4.0 * n * t * c * 2
            bound = max(ops / bf16_peak, nbytes / mem_bps) * 1e3
            times = {"kernel": [], "plain_path": []}
            for label in ("kernel", "plain_path", "plain_path", "kernel"):
                fn = ((lambda: AK.attention_bf16(qkv, heads)) if label == "kernel" else
                      (lambda: attention_core(q, k, v, heads, torch.bfloat16)))
                times[label].append(cuda_ms(fn, 20 if label == "kernel" else 3))
            issued = AK.issued_macs(n, t, c)
            useful = AK.useful_macs(n, t, c)
            ms = min(times["kernel"])
            row = {"ms": ms, "plain_path_ms": min(times["plain_path"]), "bound_ms": bound,
                   "bound_by": "bytes" if nbytes / mem_bps > ops / bf16_peak else "operations",
                   "useful_tflops": 2 * useful / ms / 1e9,
                   "issued_tflops": 2 * issued / ms / 1e9,
                   "pad_pct": 100.0 * (1 - useful / issued), "all_ms": times}
            out["times"][f"{n}x{t}x{heads}"] = row
            print(f"[15] attention ({n}, {t}, {heads} heads) a layer: kernel "
                  f"{', '.join(f'{m:.4f}' for m in times['kernel'])} ms, the plain path "
                  f"(attention_core) {', '.join(f'{m:.3f}' for m in times['plain_path'])} ms; "
                  f"bound {bound:.4f} ms ({row['bound_by']}), {bound / ms:.1%} of it; "
                  f"{row['useful_tflops']:.1f} TFLOP/s useful, {row['issued_tflops']:.1f} "
                  f"issued ({row['pad_pct']:.1f}% padding); {smi}")
        del qkv
        torch.cuda.empty_cache()

    # One batch-8 ViT-L/14@336px request in bf16 (24 launches) against the f32 encoder
    # of the same weights (TF32 off), and the spans' counters of that encode.
    g8 = golden_frames(8)
    enc = build_encoder("clip_vit_l14_336", dtype=torch.bfloat16, device="cuda")
    with full_f32():
        ref = build_encoder("clip_vit_l14_336", dtype=torch.float32,
                            device="cuda").encode(g8)["clip_embed"]
    _, got = launches_of(lambda: enc.encode(g8))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        emb = enc.encode(g8)["clip_embed"]
        torch.cuda.synchronize()
    rec = profiling.recorded()
    stats = rec.by_name()
    cos = cosine_distance(emb, ref)
    out["vit_l14_336"] = {"launches": got, "cosine_vs_f32": cos, "counters": rec.counters,
                          "attn_core_stream_ms": 1e3 * (stats["attn.core"].stream_s or 0),
                          "trunk_stream_ms": 1e3 * (stats["encode.trunk"].stream_s or 0)}
    print(f"[15] clip_vit_l14_336 bf16, 8 frames: launches {got}; clip_embed {tuple(emb.shape)} "
          f"vs the f32 encoder: cosine {cos:.3e} (limit {COSINE_LIMIT:g}); counters "
          f"{rec.counters}; attn.core {out['vit_l14_336']['attn_core_stream_ms']:.3f} of "
          f"encode.trunk's {out['vit_l14_336']['trunk_stream_ms']:.3f} stream ms")
    check(got == {"fused_preprocess": 1, **vit_pointwise_launches(24)}
          and tuple(emb.shape) == (8, 768)
          and cos <= COSINE_LIMIT and rec.counters.get("attn.issued_macs", 0) >=
          rec.counters.get("attn.useful_macs", 1) > 0,
          "clip_vit_l14_336 bf16 encode: launches, shape, cosine and counters")
    return out


def check_pointwise(card, smi):
    """Phase 16: the per-element launches of the ViT blocks (`ops/kernels/pointwise_kernel.py`)
    against their plain chains: QuickGELU bit-exact on every bf16 value and on hidden
    tensors of ViT-L/14@336px's and ViT-B/32's batch-128 shapes; the LayerNorm, alone and
    after the residual add (the sum bit-exact), within the LN contract at those shapes, the
    text tower's width and ragged widths and rows; each launch timed at ViT-L/14@336px's
    batch 128 beside its bytes bound and the plain chain; a batch-128 encode with the
    launches and with the plain chains, in turns; the launches and counters of a batch-8
    `clip_vit_l14_336` bf16 encode."""
    import torch
    import torch.nn as nn

    from embodied_clip_tpu_torch.models.encoders import build_encoder
    from embodied_clip_tpu_torch.ops.kernels import pointwise_kernel as PK
    from embodied_clip_tpu_torch.parity import (LN_SHARE, LN_STEPS, golden_frames,
                                                layer_norm_step_disagreement)
    from embodied_clip_tpu_torch.utils import profiling

    mem_bps = card[1]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    out = {"quick_gelu": {}, "layer_norm": {}, "times": {}}

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    every = torch.arange(-32768, 32768, device=dev).to(torch.int16).view(torch.bfloat16)
    want = PK.quick_gelu(every)
    nan = torch.isnan(want)
    got = PK.quick_gelu_bf16(every)
    differ = int(((got.view(torch.int16) != want.view(torch.int16)) & ~nan).sum()
                 + (nan & ~torch.isnan(got)).sum())
    out["quick_gelu"]["every_bf16_value_differing"] = differ
    print(f"[16] QuickGELU on all 65,536 bf16 values: {differ} differ from quick_gelu "
          f"({int(nan.sum())} NaN in, NaN out)")
    check(differ == 0, "QuickGELU bit-exact to quick_gelu on every bf16 value")
    for shape in ((128, 577, 4096), (128, 50, 3072), (3, 7, 24)):
        y = (randn(*shape, scale=1.5) - 0.3).to(torch.bfloat16)
        before = PK.quick_gelu_bf16.launches
        same = torch.equal(PK.quick_gelu_bf16(y), PK.quick_gelu(y))
        out["quick_gelu"][str(shape)] = same
        print(f"[16] QuickGELU {shape}: {'bit-exact' if same else 'DIFFERS'}")
        check(same and PK.quick_gelu_bf16.launches == before + 1,
              f"QuickGELU bit-exact to quick_gelu at {shape}, one launch")
        del y

    def layer_norm(c):
        ln = nn.LayerNorm(c, device=dev).requires_grad_(False)
        ln.weight.copy_(1 + randn(c, scale=0.1))
        ln.bias.copy_(randn(c, scale=0.05))
        return ln

    for rows, c in (((128, 577), 1024), ((128, 50), 768), ((3, 77), 512), ((7,), 32),
                    ((5,), 520), ((13,), 4096), ((1,), 8)):
        ln = layer_norm(c)
        x = (randn(*rows, c, scale=1.5) + randn(*rows, 1, scale=0.5)).to(torch.bfloat16)
        d = randn(*rows, c, scale=0.5).to(torch.bfloat16)
        before = PK.layer_norm_bf16.launches
        got = PK.layer_norm_bf16(x, ln)
        s_got, y_got = PK.layer_norm_bf16(x, ln, d)
        torch.cuda.synchronize()
        want = PK.layer_norm_plain(x, ln)
        s_want, y_want = PK.layer_norm_plain(x, ln, d)
        row = {"sum_bit_exact": torch.equal(s_got, s_want),
               "alone": layer_norm_step_disagreement(got, want),
               "residual": layer_norm_step_disagreement(y_got, y_want)}
        key = f"{rows}x{c}"
        out["layer_norm"][key] = row
        print(f"[16] LayerNorm {(*rows, c)}: (share differing, worst in bf16 steps) alone "
              f"{row['alone']}, after the residual add {row['residual']} (limits {LN_SHARE:g}, "
              f"{LN_STEPS:g}); the sum {'bit-exact' if row['sum_bit_exact'] else 'DIFFERS'}")
        check(row["sum_bit_exact"] and PK.layer_norm_bf16.launches == before + 2
              and all(row[k][0] <= LN_SHARE and row[k][1] <= LN_STEPS
                      for k in ("alone", "residual")),
              f"LayerNorm within the LN contract of its plain chain at {key}, the residual "
              f"sum bit-exact, one launch a call")
        del x, d, got, s_got, y_got, want, s_want, y_want

    # Times at ViT-L/14@336px's batch 128, each in turns with its plain chain.
    n, t, c = 128, 577, 1024
    ln = layer_norm(c)
    x = (randn(n, t, c, scale=1.5) + randn(n, t, 1, scale=0.5)).to(torch.bfloat16)
    d = randn(n, t, c, scale=0.5).to(torch.bfloat16)
    h = (randn(n, t, 4 * c, scale=1.5) - 0.3).to(torch.bfloat16)
    cases = {
        "layer_norm": (lambda: PK.layer_norm_bf16(x, ln), lambda: PK.layer_norm_plain(x, ln),
                       4 * x.numel()),
        "layer_norm_residual": (lambda: PK.layer_norm_bf16(x, ln, d),
                                lambda: PK.layer_norm_plain(x, ln, d), 8 * x.numel()),
        "quick_gelu": (lambda: PK.quick_gelu_bf16(h), lambda: PK.quick_gelu(h),
                       4 * h.numel())}
    for name, (kernel, plain, nbytes) in cases.items():
        times = {"kernel": [], "plain": []}
        for label in ("kernel", "plain", "plain", "kernel"):
            times[label].append(cuda_ms(kernel if label == "kernel" else plain,
                                        20 if label == "kernel" else 5))
        ms, bound = min(times["kernel"]), nbytes / mem_bps * 1e3
        out["times"][name] = {"ms": ms, "plain_ms": min(times["plain"]), "bound_ms": bound,
                              "bytes": nbytes, "all_ms": times}
        print(f"[16] {name} ({n}, {t}, {c if 'layer' in name else 4 * c}) bf16: kernel "
              f"{', '.join(f'{m:.4f}' for m in times['kernel'])} ms, the plain chain "
              f"{', '.join(f'{m:.4f}' for m in times['plain'])} ms; bound {bound:.4f} ms "
              f"({nbytes / 1e6:.0f} MB), {bound / ms:.1%} of it; {smi}")
    tm = {k: v["ms"] for k, v in out["times"].items()}
    batch_ms = 25 * tm["layer_norm"] + 24 * (tm["layer_norm_residual"] + tm["quick_gelu"])
    batch_bound = (25 * cases["layer_norm"][2] + 24 * (cases["layer_norm_residual"][2]
                                                       + cases["quick_gelu"][2])) / mem_bps * 1e3
    out["batch_ms"], out["batch_bound_ms"] = batch_ms, batch_bound
    print(f"[16] the launches of one batch-128 ViT-L/14@336px encode (25 LayerNorms, 24 "
          f"with the residual add, 24 QuickGELUs): {batch_ms:.3f} ms, bound "
          f"{batch_bound:.3f} ms")
    check(batch_ms <= 25.0, f"the launches of a batch-128 encode within 25 ms ({batch_ms:.3f})")
    del x, d, h

    # The encode: batch 128 with the launches and with the plain chains, in turns; then
    # the launches and counters of a batch-8 request.
    enc = build_encoder("clip_vit_l14_336", dtype=torch.bfloat16, device="cuda")
    x128 = torch.from_numpy(golden_frames(128)).to(dev)
    takes = PK.kernel_takes
    times = {"launches": [], "plain_chains": []}
    with torch.inference_mode():
        for label in ("launches", "plain_chains", "plain_chains", "launches"):
            PK.kernel_takes = takes if label == "launches" else (lambda *a, **k: False)
            try:
                times[label].append(cuda_ms(lambda: enc.encode(x128), 5))
            finally:
                PK.kernel_takes = takes
    out["encode_ms_batch128"] = times
    print(f"[16] clip_vit_l14_336 bf16 encode, batch 128, in turns: with the launches "
          f"{', '.join(f'{m:.2f}' for m in times['launches'])} ms, with the plain chains "
          f"{', '.join(f'{m:.2f}' for m in times['plain_chains'])} ms "
          f"({128e3 / min(times['launches']):.1f} against "
          f"{128e3 / min(times['plain_chains']):.1f} frames/s); {smi}")
    g8 = golden_frames(8)
    _, got = launches_of(lambda: enc.encode(g8))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        enc.encode(g8)
        torch.cuda.synchronize()
    counters = profiling.recorded().counters
    elements = 8 * 577 * 1024 * 49 + 8 * 577 * 4096 * 24
    out["vit_l14_336_batch8"] = {"launches": got, "counters": counters}
    print(f"[16] clip_vit_l14_336 bf16, 8 frames: launches {got}; pw.elements "
          f"{counters.get('pw.elements')}, pw.fused_elements "
          f"{counters.get('pw.fused_elements')} (expected {elements} each)")
    check(got == {"fused_preprocess": 1, **vit_pointwise_launches(24)}
          and counters.get("pw.elements") == counters.get("pw.fused_elements") == elements,
          "clip_vit_l14_336 bf16 encode: 49 LayerNorm and 24 QuickGELU launches, every "
          "element counted fused")
    return out


def check_clip_towers(smi):
    """Phase 11 (b): the dual-tower CLIP of RN50 and ViT-B/32 at full width, f32 and
    bf16: the zero-shot goal table and the contrastive logits of golden_frames(8).
    Returns ({name: stats}, RN50's f32 table)."""
    import torch

    from embodied_clip_tpu_torch import constants
    from embodied_clip_tpu_torch.models.clip import build_clip, image_size_of
    from embodied_clip_tpu_torch.models.tokenizer import SimpleTokenizer, tokenize
    from embodied_clip_tpu_torch.ops.int8 import full_f32
    from embodied_clip_tpu_torch.ops.preprocess import make_preprocessor
    from embodied_clip_tpu_torch.parity import golden_frames
    from embodied_clip_tpu_torch.zeroshot import DEFAULT_PROMPT, text_goal_table

    names = constants.ROBOTHOR_OBJECT_TYPES
    tok = SimpleTokenizer()
    tokens = torch.from_numpy(tokenize([DEFAULT_PROMPT.format(n.lower()) for n in names],
                                       tok, truncate=True)).cuda()
    g8 = torch.from_numpy(golden_frames(8)).cuda()
    out, rn50_table = {}, None
    for name, dim in (("RN50", 1024), ("ViT-B/32", 512)):
        tables, stats = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            label = "f32" if dtype == torch.float32 else "bf16"
            t0 = time.perf_counter()
            clip = build_clip(name, dtype, device="cuda")
            build_s = time.perf_counter() - t0
            pre = make_preprocessor("clip", image_size_of(name), dtype)
            with full_f32():
                table = text_goal_table(clip, tok, names)  # an ordinary tensor
                with torch.inference_mode():
                    li, lt = clip(pre(g8), tokens)
                    text_ms = cuda_ms(lambda: clip.encode_text(tokens), 10)
            norms = table.norm(dim=-1)
            check(tuple(table.shape) == (12, dim) and table.dtype == torch.float32
                  and float((norms - 1).abs().max()) <= 1e-5,
                  f"{name} {label} goal table (12, {dim}) of unit rows")
            check(tuple(li.shape) == (8, 12) and torch.equal(lt, li.t())
                  and bool(torch.isfinite(li).all())
                  and float(li.abs().max()) <= float(clip.logit_scale.exp()) * (1 + 1e-5),
                  f"{name} {label} logits (8, 12), logits_per_text their transpose")
            tables[label] = table
            stats[label] = {"text_encode_ms_12_prompts": text_ms, "build_s": build_s,
                            "logits_row0": [round(float(v), 4) for v in li[0]]}
            print(f"[11b] CLIP {name} {label}: built in {build_s:.2f} s; goal table "
                  f"{tuple(table.shape)}, row norms 1 ± {float((norms - 1).abs().max()):.1e};"
                  f" logits of golden_frames(8) vs the 12 prompts {tuple(li.shape)}, "
                  f"logits_per_text its transpose, image 0: "
                  f"{[round(float(v), 3) for v in li[0]]}; 12-prompt text encode "
                  f"{text_ms:.3f} ms; {smi}")
            del clip
        rows = 1.0 - (tables["bf16"] * tables["f32"]).sum(-1)  # unit rows
        worst = float(rows.max())
        stats["bf16_vs_f32_row_cosine_max"] = worst
        print(f"[11b] CLIP {name}: bf16 goal table vs f32, row by row: worst cosine "
              f"distance {worst:.3e} (limit {COSINE_LIMIT:g})")
        check(worst <= COSINE_LIMIT, f"{name} bf16 goal table within {COSINE_LIMIT:g} of f32")
        out[name] = stats
        if name == "RN50":
            rn50_table = tables["f32"]
    torch.cuda.empty_cache()
    return out, rn50_table


def check_zeroshot(card, smi, table):
    """Phase 11 (c): zero-shot ObjectNav DD-PPO at phase 9's width: RN50's text-goal
    table through `_GoalMappedEnv` on the seen classes, 3 iterations, then evaluation on
    all 12 classes."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from embodied_clip_tpu_torch import constants
    from embodied_clip_tpu_torch.config.rl_experiments import _GoalMappedEnv
    from embodied_clip_tpu_torch.envs.gridworld import GridNavEnv
    from embodied_clip_tpu_torch.models.policy import ActorCritic
    from embodied_clip_tpu_torch.parallel.distributed import initialize_distributed
    from embodied_clip_tpu_torch.parallel.dryrun import free_port
    from embodied_clip_tpu_torch.training.ddppo import DDPPOConfig, DDPPOLearner
    from embodied_clip_tpu_torch.training.evaluate import evaluate_policy
    from embodied_clip_tpu_torch.training.frames import frozen_encode_fn
    from embodied_clip_tpu_torch.training.ppo import PPOConfig
    from embodied_clip_tpu_torch.zeroshot import goal_map_fn, seen_unseen_class_ids

    check(initialize_distributed(f"localhost:{free_port()}", 1, 0, device="cuda")
          and dist.get_backend() == "nccl", "a one-process NCCL group")
    names = constants.ROBOTHOR_OBJECT_TYPES
    seen, unseen = seen_unseen_class_ids()
    goal_map = goal_map_fn(table)
    env = _GoalMappedEnv(GridNavEnv(size=8, max_steps=64, frame_obs=True, class_set=seen),
                         goal_map)
    cfg = DDPPOConfig(rollout_len=64, env_batch=32, ppo=PPOConfig(lr=3e-4, epochs=4))
    fe, is_map = frozen_encode_fn("clip_rn50", torch.bfloat16, device="cuda")
    policy = ActorCritic(env.num_actions, fe.feature_shape, goal_kind="text_embed",
                         goal_input_dim=table.shape[1], hidden=512, visual_is_map=is_map)
    learner = DDPPOLearner(env, policy, cfg, encode_fn=fe, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    act = learner.init(gen)
    before = [p.detach().clone() for p in policy.parameters()]
    encodes = cfg.rollout_len + 1
    want = {"fused_preprocess": encodes, "fused_stage1": encodes,
            "fused_bottleneck": 10 * encodes, "fused_stride_block_bf16": 3 * encodes}
    out = {"iterations": []}
    for it in range(3):
        frames0 = act.obs["visual"].clone()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        (act, metrics), got = launches_of(lambda: learner.train_iteration(act, gen))
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        check(got == want, f"zero-shot launches per iteration {got}, expected {want}")
        loss = float(metrics["loss"])
        check(np.isfinite(loss), "zero-shot loss finite")
        r = {"iteration_ms": ms, "env_steps_per_s": cfg.rollout_len * cfg.env_batch / ms * 1e3,
             "loss": loss, "success": float(metrics["success"])}
        out["iterations"].append(r)
        print(f"[11c] zero-shot iteration {it}: {ms:.1f} ms, {r['env_steps_per_s']:.0f} "
              f"env-steps/s; loss {loss:.4f}; launches {got}; {smi}")
        if it == 0:
            check(tuple(frames0.shape) == (32, 56, 56, 3), "the rollout's frames")
            out["rollout_calls_held"] = hold_rollout_calls(fe, frames0, "bf16", phase="11c")
    check(any(not torch.equal(a, b) for a, b in zip(before, policy.parameters())),
          "zero-shot: the policy's weights changed")
    out["launches"] = got
    out["k1_rollout_shape"] = hold_k1(frames0, card, smi, "11c", "the zero-shot rollout's shape")

    eval_env = GridNavEnv(size=8, max_steps=64, frame_obs=True)  # all 12 classes
    t0 = time.perf_counter()
    recs = evaluate_policy(eval_env, policy, gen, num_episodes=64, env_batch=32,
                           encode_fn=fe, goal_map_fn=goal_map, class_names=names)
    eval_s = time.perf_counter() - t0
    check(len(recs) == 64 and all(r["task_info"]["object_type"] in names for r in recs),
          "64 evaluation episodes, each under one of the 12 class names")
    split = {}
    for label, ids in (("seen", seen), ("unseen", unseen)):
        mine = [r for r in recs if names.index(r["task_info"]["object_type"]) in ids]
        split[label] = {"episodes": len(mine),
                        "success": float(np.mean([r["success"] for r in mine])) if mine else None,
                        "spl": float(np.mean([r["spl"] for r in mine])) if mine else None}
    out["evaluation"] = {"seconds": eval_s, **split}
    print(f"[11c] zero-shot evaluation, 64 episodes over the 12 classes in {eval_s:.2f} s "
          f"(random weights: no limit): " + "; ".join(
              f"{k} {v['episodes']} episodes, success {v['success']}, SPL {v['spl']}"
              for k, v in split.items()))
    dist.destroy_process_group()
    return out


def exact_disagreements(args, kw):
    """One K6 call's kernel output and its plain version against the same arithmetic
    (the same bf16 rounding points: h1, h2, the output) accumulated in float64: the
    share of elements each differs on."""
    import torch
    import torch.nn.functional as F

    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
    from embodied_clip_tpu_torch.parity import bf16_disagreement

    x = args[0]
    dt, f64 = x.dtype, torch.float64

    def w(name):
        return kw[name].to(dt).to(f64)

    h1 = torch.relu(x.to(f64) @ w("w1") + kw["b1"].to(f64)).to(dt)
    acc = F.conv2d(h1.to(f64).permute(0, 3, 1, 2), w("w2").permute(3, 2, 0, 1), padding=1)
    h2 = torch.relu(acc.permute(0, 2, 3, 1) + kw["b2"].to(f64)).to(dt)
    exact = torch.relu(h2.to(f64) @ w("w3") + kw["b3"].to(f64) + x.to(f64)).to(dt)
    got, plain = BK.fused_bottleneck(x, **kw), BK.fused_bottleneck_reference(x, **kw)
    return bf16_disagreement(got, exact)[0], bf16_disagreement(plain, exact)[0]


def check_rn50x16(card, smi):
    """Phase 11 (d): one batch-8 `clip_rn50x16` request at 384 px, bf16 folded (K1's
    upscale, K7 over the 6-block stage 1, 31 × K6) and int8 path A (K1, K2, K5 × 3), every
    kernel call held to its plain version; the embeds against f32."""
    import torch

    from embodied_clip_tpu_torch.models.encoders import build_encoder
    from embodied_clip_tpu_torch.ops.int8 import full_f32
    from embodied_clip_tpu_torch.parity import cosine_distance, golden_frames

    frames = torch.from_numpy(golden_frames(8)).cuda()
    shapes = {"clip_conv": (8, 12, 12, 3072), "clip_avgpool": (8, 3072),
              "clip_attnpool": (8, 768)}
    with full_f32():
        ref = build_encoder("clip_rn50x16", dtype=torch.float32, device="cuda").encode(frames)
    enc = build_encoder("clip_rn50x16", dtype=torch.bfloat16, device="cuda").fold_bn()
    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK

    out = {}
    per_request = {"bf16": {"fused_stage1": 1, "fused_bottleneck": 31,
                            "fused_stride_block_bf16": 3},
                   "int8": {"stem12_f32": 1, "stem3_requant_pool_int8": 1,
                            "fused_resblocks_int8": 3, "fused_stride_block_int8": 3}}
    for label in ("bf16", "int8"):
        if label == "int8":
            t0 = time.perf_counter()
            enc = enc.quantize(golden_frames(32))
            torch.cuda.synchronize()
            print(f"[11d] clip_rn50x16 quantized (calibrated on golden_frames(32), 384 px) in "
                  f"{time.perf_counter() - t0:.2f} s")
        got, launches = launches_of(lambda: enc.encode(frames))
        want = {"fused_preprocess": 1, **per_request[label]}
        check(launches == want, f"clip_rn50x16 {label} launches {launches}, expected {want}")
        check({k: tuple(v.shape) for k, v in got.items()} == shapes
              and all(v.dtype == torch.bfloat16 and bool(torch.isfinite(v.float()).all())
                      for v in got.values()), f"clip_rn50x16 {label} response")
        cos = {k: cosine_distance(got[k], ref[k]) for k in ref}
        held = hold_rollout_calls(enc.encode, frames, label, phase="11d",
                                  per_encode=per_request[label])
        if label == "bf16":
            # The K6 calls against float64 arithmetic, stage by stage (the calls of a
            # stage share their shape): the kernel no farther from it than
            # EXACT_SHARE_RATIO × the plain version.
            with torch.inference_mode():
                with Recorder(BK, "fused_bottleneck") as r6:
                    enc.encode(frames)
                pairs = [exact_disagreements(args, kw) for args, kw, _ in r6.calls]
                stages = [tuple(args[0].shape) for args, _, _ in r6.calls]
            out["k6_vs_float64"] = [{"shape": list(st), "kernel": a, "plain": b}
                                    for st, (a, b) in zip(stages, pairs)]
            for st in dict.fromkeys(stages):
                calls = [p for p, shape in zip(pairs, stages) if shape == st]
                pooled = sum(a for a, _ in calls) / max(sum(b for _, b in calls), 1e-6)
                plain_max = max(b for _, b in calls)
                worst = max(a for a, _ in calls)
                print(f"[11d] clip_rn50x16 bf16: {len(calls)} K6 calls at {st} against the "
                      f"same arithmetic in float64: the kernel differs on {pooled:.3f}× the "
                      f"elements its plain version does (limit ×{EXACT_SHARE_RATIO}); its "
                      f"worst call on {worst:.2e}, the plain version's on {plain_max:.2e} "
                      f"(limit ×{EXACT_SHARE_RATIO})")
                check(pooled <= EXACT_SHARE_RATIO
                      and worst <= EXACT_SHARE_RATIO * max(plain_max, 1e-4),
                      f"clip_rn50x16 K6 calls at {st} as close to float64 arithmetic as "
                      "the plain version")
        ms = cuda_ms(lambda: enc.encode(frames), 5)
        print(f"[11d] clip_rn50x16 {label}: batch-8 request (300×300 → 384) launches "
              f"{launches}; "
              f"vs the f32 unfolded encoder (TF32 off), cosine "
              + ", ".join(f"{k} {v:.3e}" for k, v in cos.items())
              + (f" (limit {COSINE_LIMIT:g})" if label == "bf16" else " (printed, no limit)")
              + f"; encode {ms:.3f} ms on the device; {smi}")
        if label == "bf16":
            check(all(v <= COSINE_LIMIT for v in cos.values()),
                  f"clip_rn50x16 bf16 within {COSINE_LIMIT:g} of f32")
        out[label] = {"launches": launches, "cosine_vs_f32": cos, "calls_held": held,
                      "encode_ms_batch8": ms}
    return out


def registry_state(exp):
    """The policy's weights after `exp.train` (copies)."""
    return {k: v.detach().clone() for k, v in exp._last_policy.state_dict().items()}


def state_distance(a, b) -> float:
    """The largest |difference| over two state_dicts' tensors (0.0: bit-equal)."""
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def latest_checkpoint(directory):
    names = sorted(n for n in os.listdir(directory) if "__steps_" in n)
    check(bool(names), f"a step checkpoint in {directory}")
    return os.path.join(directory, names[-1])


def check_registry(card, smi):
    """Phase 12: the RL experiment registry at full width on the card, through
    `get_experiment`: (a) DD-PPO trained 3 iterations, and 2 then resumed to 3 from the
    step checkpoint, bit-equal; (b) int8 path A, 1 iteration, calibrated on the golden
    frames and the env's; (c) zero-shot training, then `evaluate(ckpt=…)` over the 12
    classes; (d) the habitat knobs (2 epochs × 2 minibatches, linear LR decay); (e) the
    host path over the scripted THOR controller: train, resume, evaluate on the val
    scenes; (f) DAgger on the fake rearrangement."""
    import tempfile

    import numpy as np
    import torch

    from embodied_clip_tpu_torch import constants
    from embodied_clip_tpu_torch.config.experiments import get_experiment, list_experiments
    from embodied_clip_tpu_torch.envs.vector import stop_fork_server
    from embodied_clip_tpu_torch.models import encoders
    from embodied_clip_tpu_torch.parity import golden_frames
    from embodied_clip_tpu_torch.training.evaluate import compute_scores
    from embodied_clip_tpu_torch.utils.checkpoint import restore_pytree

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from fake_thor import FakeController

    check(len([n for n in list_experiments() if not n.startswith("probe_")]) == 18,
          "the registry holds the 18 RL experiments")
    name = "objectnav_robothor_rgb_clipresnet50gru_ddppo"
    per_iter = 32 * 64
    encodes = 64 + 1
    bf16_want = {"fused_preprocess": encodes, "fused_stage1": encodes,
                 "fused_bottleneck": 10 * encodes, "fused_stride_block_bf16": 3 * encodes}
    out = {}
    tmp = tempfile.mkdtemp(prefix="registry_")

    def experiment(exp_name, iters, *more, steps=per_iter):
        return get_experiment(exp_name, [f"total_env_steps={iters * steps}",
                                         f"ckpt_every_steps={steps}", *more])

    def train(exp, directory, iters, label, want=None):
        """exp.train(directory) with the launches counted (its encoder built first, so
        that the counts are the training's alone)."""
        exp._encode_fn()
        t0 = time.perf_counter()
        res, got = launches_of(lambda: exp.train(directory))
        wall = time.perf_counter() - t0
        check(np.isfinite(res.get("loss", np.nan)), f"({label}) loss finite")
        if want is not None:
            per = {k: v // iters for k, v in got.items()}
            check(per == want and all(v % iters == 0 for v in got.values()),
                  f"({label}) launches per iteration {got} over {iters}, expected {want}")
        print(f"[12{label[0]}] {exp.name} ({label}): {iters} iteration(s) to env step "
              f"{res['env_steps']} in {wall:.2f} s, {res['env_steps_per_s']:.0f} "
              f"env-steps/s (train's own metric), loss {res['loss']:.4f}; launches {got}; "
              f"{smi}")
        return res, got

    try:
        # -- (a) DD-PPO, and the same run stopped at iteration 2 and resumed -------------
        torch.use_deterministic_algorithms(True)
        try:
            full = experiment(name, 3)
            check(full.backend == "fake" and full.encoder == "clip_rn50"
                  and full.env_batch == 32 and full.rollout_len == 64
                  and full.hidden == 512 and full.ppo_epochs == 4
                  and full.encoder_dtype == "bfloat16", f"(a) {name} as registered")
            res, got = train(full, os.path.join(tmp, "full"), 3, "a uninterrupted",
                             bf16_want)
            want_state = registry_state(full)
            ckpt = latest_checkpoint(os.path.join(tmp, "full", name))
            ckpt_mb = os.path.getsize(ckpt) / 2 ** 20
            half = experiment(name, 2)
            train(half, os.path.join(tmp, "split"), 2, "a stopped at iteration 2",
                  bf16_want)
            resumed = experiment(name, 3)
            res_r, got_r = train(resumed, os.path.join(tmp, "split"), 1,
                                 "a resumed to iteration 3", bf16_want)
            check(res_r["env_steps"] == 3 * per_iter, "(a) resumed at env step 4096")
            got_state = registry_state(resumed)
            dist_resumed = state_distance(got_state, want_state)
            bit_equal = all(torch.equal(got_state[k], want_state[k]) for k in want_state)
            opt = restore_pytree(ckpt)["opt_state"]
            check(int(opt["count"]) == 12, "(a) 12 optimizer updates in the checkpoint")
        finally:
            torch.use_deterministic_algorithms(False)
        print(f"[12a] resumed vs uninterrupted policy weights: max |diff| "
              f"{dist_resumed:.3e} (deterministic algorithms on); checkpoint "
              f"{os.path.basename(ckpt)} {ckpt_mb:.2f} MiB on disk; {smi}")
        check(bit_equal, "(a) the resumed run's weights bit-equal to the uninterrupted "
                         "run's")
        out["a"] = {"env_steps_per_s": res["env_steps_per_s"],
                    "iteration_time_s": res["iteration_time_s"],
                    "resumed_env_steps_per_s": res_r["env_steps_per_s"],
                    "launches_per_iteration": {k: v // 3 for k, v in got.items()},
                    "resumed_vs_uninterrupted_max_abs": dist_resumed,
                    "checkpoint_mib": ckpt_mb}

        # -- (b) int8 path A, 1 iteration ----------------------------------------------
        q = experiment(name, 1, "encoder_dtype=int8")
        seen = []
        quantize = encoders.FrozenEncoder.quantize

        def spy(self, frames):
            seen.append(np.array(frames))
            return quantize(self, frames)

        encoders.FrozenEncoder.quantize = spy
        try:
            fe = q._encode_fn()
        finally:
            encoders.FrozenEncoder.quantize = quantize
        calib = q._calibration_frames()
        check(len(seen) == 1 and np.array_equal(seen[0], calib)
              and calib.shape == (24, 300, 300, 3)
              and np.array_equal(calib[:16], golden_frames(16)),
              "(b) calibrated on golden_frames(16) and 8 frames of the env")
        int8_want = {k: v * encodes for k, v in PER_REQUEST["A"].items() if v}
        res_q, got_q = train(q, os.path.join(tmp, "int8"), 1, "b int8 path A", int8_want)
        frames = q._last_env.reset(torch.Generator(device="cuda").manual_seed(0), 32)[1]
        frames = frames["visual"]
        check(tuple(frames.shape) == (32, 56, 56, 3), "(b) the rollout's frames")
        held = hold_rollout_calls(fe, frames, "int8", phase="12b")
        out["b"] = {"env_steps_per_s": res_q["env_steps_per_s"],
                    "launches_per_iteration": got_q, "rollout_calls_held": held}

        # -- (c) zero-shot: train, then evaluate the checkpoint on the 12 classes --------
        zs = experiment("zeroshot_objectnav_robothor_rgb_clipresnet50gru_ddppo", 2)
        res_z, _ = train(zs, os.path.join(tmp, "zs"), 2, "c zero-shot", bf16_want)
        zckpt = latest_checkpoint(os.path.join(tmp, "zs", zs.name))
        ev = get_experiment("zeroshot_objectnav_robothor_rgb_clipresnet50gru_ddppo_eval",
                            ["eval_episodes=64"])
        t0 = time.perf_counter()
        overall = ev.evaluate(os.path.join(tmp, "zs_eval"), ckpt=zckpt)
        eval_s = time.perf_counter() - t0
        path = os.path.join(tmp, "zs_eval", ev.name, "metrics.json")
        check(overall["episodes"] == 64 and overall["metrics_file"] == path
              and os.path.exists(path), "(c) metrics.json of 64 episodes")
        names = constants.ROBOTHOR_OBJECT_TYPES
        split = {}
        for label, group in (("seen", constants.ZEROSHOT_SEEN_OBJECTS),
                             ("unseen", constants.ZEROSHOT_UNSEEN_OBJECTS)):
            scores = [compute_scores(path, t) for t in group
                      if t in overall["per_object_type"]]
            n = sum(1 for t in overall["per_object_type"] if t in group)
            split[label] = {"classes": n,
                            "success": float(np.mean([s for s, _ in scores])) if scores else None,
                            "spl": float(np.mean([p for _, p in scores])) if scores else None}
        check(set(overall["per_object_type"]) <= set(names) and split["unseen"]["classes"],
              "(c) the evaluation covers unseen classes, under their names")
        print(f"[12c] zero-shot evaluation from {os.path.basename(zckpt)}: 64 episodes in "
              f"{eval_s:.2f} s over {len(overall['per_object_type'])} of the 12 classes "
              f"(random weights: no limit): " + "; ".join(
                  f"{k} {v['classes']} classes, success {v['success']}, SPL {v['spl']}"
                  for k, v in split.items()) + f"; {smi}")
        out["c"] = {"env_steps_per_s": res_z["env_steps_per_s"], "eval_seconds": eval_s,
                    **split}

        # -- (d) the habitat DD-PPO knobs --------------------------------------------
        hb = experiment("ddppo_pointnav_rgb_clip", 2)
        check(hb.ppo_epochs == 2 and hb.num_minibatches == 2 and hb.lr_decay_updates == -1,
              "(d) 2 epochs × 2 minibatches, linear decay to 0")
        res_h, _ = train(hb, os.path.join(tmp, "habitat"), 2, "d habitat knobs", bf16_want)
        tx = hb._last_learner.tx
        horizon = hb._lr_decay_updates()
        lr_now = hb.lr * (1.0 - min(tx.count, horizon) / horizon)
        check(horizon == 8 and tx.decay_updates == horizon and tx.count == 8
              and tx.learning_rate() == lr_now == 0.0,
              f"(d) the LR after {tx.count} updates is the linear schedule's over {horizon}")
        print(f"[12d] {hb.name}: {tx.count} optimizer updates over a horizon of {horizon}; "
              f"the next LR {tx.learning_rate()} (the schedule's: {lr_now})")
        out["d"] = {"env_steps_per_s": res_h["env_steps_per_s"], "updates": tx.count,
                    "lr_horizon": horizon}

        # -- (e) the host path: train, resume, evaluate on the simulator ----------------
        host_steps = 64 * 8
        host = ["backend=thor", "max_episode_steps=40"]

        def host_experiment(iters, *more):
            exp = experiment(name, iters, *host, *more, steps=host_steps)
            exp.controller_factory = FakeController
            return exp

        ht = host_experiment(2)
        check(ht.num_workers == 8, "(e) 8 workers")
        res_t, _ = train(ht, os.path.join(tmp, "thor"), 2, "e host PPO", bf16_want)
        hr = host_experiment(3)
        res_r, _ = train(hr, os.path.join(tmp, "thor"), 1, "e host resumed to 3",
                         bf16_want)
        hckpt = latest_checkpoint(os.path.join(tmp, "thor", name))
        check(int(restore_pytree(hckpt)["opt_state"]["count"]) == 12,
              "(e) the resumed run restored the optimizer state (12 updates)")
        he = host_experiment(3, "eval_episodes=16")
        t0 = time.perf_counter()
        overall_h = he.evaluate(os.path.join(tmp, "thor_eval"), ckpt=hckpt)
        eval_h = time.perf_counter() - t0
        check(overall_h["episodes"] == 16 and os.path.exists(overall_h["metrics_file"]),
              "(e) 16 evaluation episodes on the val scenes, metrics.json written")
        print(f"[12e] host evaluation (val scenes, horizon 40) from "
              f"{os.path.basename(hckpt)}: 16 episodes in {eval_h:.2f} s, success "
              f"{overall_h['success']}, SPL {overall_h['spl']}; {smi}")
        out["e"] = {"env_steps_per_s": res_t["env_steps_per_s"],
                    "resumed_env_steps_per_s": res_r["env_steps_per_s"],
                    "eval_seconds": eval_h}

        # -- (f) DAgger on the fake rearrangement ---------------------------------------
        dg = experiment("one_phase_rgb_clipresnet50_dagger", 2)
        res_d, got_d = train(dg, os.path.join(tmp, "dagger"), 2, "f DAgger")
        check(not got_d, "(f) the fake rearrangement's symbolic maps launch no kernel")
        out["f"] = {"env_steps_per_s": res_d["env_steps_per_s"], "loss": res_d["loss"]}
    finally:
        stop_fork_server()
        shutil.rmtree(tmp, ignore_errors=True)
    left = descendants()
    check(not left, f"(e) every worker, the fork server and its tracker have ended, "
                    f"left: {left}")
    out["card"] = smi
    return out


# -- phase 13: the probing stack ------------------------------------------------------

# The reference's split (thor_frames.py:44-52,58) cut to 4 train, 2 val and 2 test scenes
# at its frames per scene.
PROBE_SCENES = {"train": ("FloorPlan1", "FloorPlan2", "FloorPlan3", "FloorPlan4"),
                "val": ("FloorPlan21", "FloorPlan22"), "test": ("FloorPlan26", "FloorPlan27")}
# Launches per 256-frame extraction batch of imagenet_rn50 + clip_rn50 (bf16 unfolded:
# K1 per encoder; int8: K1 per encoder, clip_rn50's path A, imagenet_rn50's plain graph).
EXTRACTION_PER_BATCH = {"bfloat16": {"fused_preprocess": 2},
                        "int8": {"fused_preprocess": 2, "stem12_f32": 1,
                                 "stem3_requant_pool_int8": 1,
                                 "fused_stage1_int8": 1, "fused_resblocks_int8": 3,
                                 "fused_stride_block_int8": 3}}
STORE_SHAPES = {"imagenet_conv": (7, 7, 2048), "imagenet_avgpool": (2048,),
                "clip_conv": (7, 7, 2048), "clip_avgpool": (2048,), "clip_attnpool": (1024,),
                "object_presence": (52,), "object_localization": (9, 52), "free_space": ()}
FEATURE_KEYS = tuple(STORE_SHAPES)[:5]
# One probe per prediction type, held on the card against the CPU.
PROBE_PAIRS = (("object_presence", "clip_avgpool"), ("object_localization", "clip_avgpool"),
               ("reachability", "clip_attnpool"), ("free_space", "imagenet_avgpool"))
CARD_VS_CPU_LIMIT = 1e-4
# verify-parity thresholds of phase 13 (g): the north star in f32 and bf16; in int8 the
# conv-map limit would be 2e-3, but on the seed-7 oracle checkpoint (torch's default
# init) the JAX package's own int8 graph is at 2.124e-3 on clip_conv (the port 2.093e-3,
# both on the CPU), so clip_rn50 is held to that, rounded up; imagenet_rn18 to the JAX
# package's own int8 parity threshold (tests/test_verify_parity.py:64).
VERIFY_THRESHOLDS = {"clip_rn50": {"float32": 1e-3, "bfloat16": 1e-3, "int8": 2.5e-3},
                     "imagenet_rn18": {"float32": 1e-3, "bfloat16": 1e-3, "int8": 2e-2}}
FULL_SPLIT = {"train": 6000, "val": 750, "test": 750}  # 7,500 frames: 60/15/15 scenes


def run_cli(argv):
    """(exit code, captured stdout) of `embodied_clip_tpu_torch.cli.main(argv)` in this
    process, so that the kernels' launches are counted."""
    import contextlib
    import io

    from embodied_clip_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            code = cli.main(argv)
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue()


def probe_scene_files(root):
    """Phase 13 (a): scene files in thor_frames.py's format under root/{split}, and per
    split the frames and the labels the planting implies: (frames, presence (n, 52),
    localization (n, 9, 52), free space (n,)). Frame k is a golden-frame texture (rolled
    by k), with TARGET_OBJECTS[k % 52] planted in grid cell k % 9 and a second object in
    cell (k + 4) % 9 (a 60×60 patch inside the cell); valid_moves_forward = k % 14."""
    import numpy as np

    from embodied_clip_tpu_torch.constants import TARGET_OBJECTS
    from embodied_clip_tpu_torch.generate_data.thor_frames import (
        FRAMES_PER_SCENE,
        split_of_scene,
    )
    from embodied_clip_tpu_torch.parity import golden_frames

    colors = {o: (20 + 4 * i, 255 - 4 * i, (37 * i) % 256) for i, o in enumerate(TARGET_OBJECTS)}
    colors["Floor|+00.00|+00.00"] = (3, 3, 3)  # an id that is no target class
    base = golden_frames(60)
    out, k = {}, 0
    for split, scenes in PROBE_SCENES.items():
        frames, pres, loc, free = [], [], [], []
        os.makedirs(os.path.join(root, split))
        for scene in scenes:
            check(split_of_scene(scene) == split, f"{scene} is a {split} scene")
            records = []
            for _ in range(FRAMES_PER_SCENE[split]):
                frame = np.ascontiguousarray(np.roll(base[k % 60], (7 * (k // 60), 13 * (k // 60)),
                                                     axis=(0, 1)))
                sem = np.zeros((300, 300, 3), np.uint8)
                sem[:, :10] = colors["Floor|+00.00|+00.00"]
                p, g = np.zeros(52, np.int64), np.zeros((9, 52), np.int64)
                a, b = k % 52, (7 * k + 3) % 52
                for obj, cell in ((a, k % 9), (b, (k + 4) % 9)):
                    r, c = divmod(cell, 3)
                    sem[100 * r + 20:100 * r + 80, 100 * c + 20:100 * c + 80] = \
                        colors[TARGET_OBJECTS[obj]]
                    p[obj], g[cell, obj] = 1, 1
                records.append({"frame": frame, "semantic_frame": sem,
                                "object_id_to_color": colors, "valid_moves_forward": k % 14})
                frames.append(frame)
                pres.append(p)
                loc.append(g)
                free.append(k % 14)
                k += 1
            np.save(os.path.join(root, split, f"{scene}.npy"), records)
        out[split] = (np.stack(frames), np.stack(pres), np.stack(loc), np.asarray(free))
    return out


def check_probing(card, smi, profile):
    """Phase 13: the probing stack on the card, through the CLI's subcommands in this
    process (`cli.main`) where the step names one: (a) scene files; (b)
    `extract-features` of imagenet_rn50 + clip_rn50 at batch 256 in f32, bf16 and int8;
    (c) a reachability store; (d) `probe-sweep` over the 11 probes, and one probe per
    prediction type on the card against the CPU; (e) `probe-train --eval --ckpt` and
    `train --config probe_* [--eval]`; (f) one probe at the reference's full split
    sizes; (g) `verify-parity` on oracle checkpoints; (h) `list-configs`; (i) the
    data-parallel probe trainer in 2 NCCL processes where 2 cards are present.

    Cuts, for the run's time: the reference's 60/15/15 scenes (7,500 frames) become
    4/2/2 (600 frames at its 100/50/50 frames a scene); the synthetic frames are
    golden-frame textures with planted semantic patches; the reachability store is 256
    synthetic images; (d) and (e) train 2 epochs and (f) 5 of the reference's 250. The
    models run at full width."""
    import tempfile

    import numpy as np
    import torch

    from embodied_clip_tpu_torch.config.experiments import list_experiments
    from embodied_clip_tpu_torch.constants import TARGET_OBJECTS
    from embodied_clip_tpu_torch.data import feature_store as FS
    from embodied_clip_tpu_torch.data.probing import ProbeDataModule, load_probe_split
    from embodied_clip_tpu_torch.generate_data.reachable_metadata import build_split_triples
    from embodied_clip_tpu_torch.ops.preprocess import make_preprocessor
    from embodied_clip_tpu_torch.parity import cosine_distance, golden_frames
    from embodied_clip_tpu_torch.training import supervised as SUP

    tests_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests_dir not in sys.path:
        sys.path.insert(0, tests_dir)
    import torch_oracle as O

    out = {"card": smi, "cards": torch.cuda.device_count()}
    tmp = tempfile.mkdtemp(prefix="probing_")
    try:
        # -- (a) scene files ------------------------------------------------------------
        t0 = time.perf_counter()
        scenes = os.path.join(tmp, "scenes")
        truth = probe_scene_files(scenes)
        n_frames = sum(len(v[0]) for v in truth.values())
        check(n_frames == 600, f"(a) 600 frames, got {n_frames}")
        print(f"[13a] {n_frames} scene frames (300×300, train/val/test "
              f"{', '.join(str(len(v[0])) for v in truth.values())}) written in "
              f"{time.perf_counter() - t0:.2f} s")

        # -- (b) extract-features in f32, bf16 and int8 --------------------------------
        stores, ext = {}, {}
        write_split = FS.FeatureStoreWriter.write_thor_split
        for dtype in ("float32", "bfloat16", "int8"):
            splits, encoders = [], {}

            def timed(self, out_dir, split, _splits=splits, _encs=encoders, **kw):
                path = write_split(self, out_dir, split, **kw)
                _splits.append((split, len(kw["frames"]), dict(self.last_split_s)))
                _encs.update(self.encoders)
                return path

            FS.FeatureStoreWriter.write_thor_split = timed
            try:
                t0 = time.perf_counter()
                (code, _), got = launches_of(lambda: run_cli([
                    "extract-features", "--data-dir", scenes, "--output-dir",
                    os.path.join(tmp, dtype), "--encoders", "imagenet_rn50,clip_rn50",
                    "--batch-size", "256", "--dtype", dtype]))
                wall = time.perf_counter() - t0
            finally:
                FS.FeatureStoreWriter.write_thor_split = write_split
            check(code == 0, f"(b) extract-features --dtype {dtype} exits 0")
            batches = sum(-(-n // 256) for _, n, _ in splits)
            calib = {"fused_preprocess": 2} if dtype == "int8" else {}  # one a encoder
            want = {k: v * batches + calib.get(k, 0)
                    for k, v in EXTRACTION_PER_BATCH.get(dtype, {}).items()}
            check(got == want, f"(b) {dtype} launches {got}, expected {want} ({batches} "
                               f"batches)")
            enc_s = sum(s["encode"] for _, _, s in splits)
            split_s = {k: sum(s[k] for _, _, s in splits) for k in ("encode", "labels", "write")}
            stores[dtype] = {}
            for split, (frames, pres, loc, free) in truth.items():
                with np.load(os.path.join(tmp, dtype, f"thor_{split}.npz")) as z:
                    stores[dtype][split] = {k: z[k] for k in z.files}
                s = stores[dtype][split]
                n = len(frames)
                check(set(s) == set(STORE_SHAPES) | {"scene"}, f"(b) {dtype} keys {sorted(s)}")
                for key, shape in STORE_SHAPES.items():
                    check(s[key].shape == (n, *shape), f"(b) {dtype} {split} {key} "
                                                       f"{s[key].shape}")
                check(all(np.isfinite(s[k]).all() for k in FEATURE_KEYS),
                      f"(b) {dtype} {split}: finite features")
                check(np.array_equal(s["object_presence"], pres)
                      and np.array_equal(s["object_localization"], loc)
                      and np.array_equal(s["free_space"], free),
                      f"(b) {dtype} {split}: the planted objects present in their cells "
                      f"and in no other, free space as planted")
            ext[dtype] = {"launches": got, "batches": batches, "wall_s": wall,
                          "encode_frames_per_s": n_frames / enc_s, "split_s": split_s,
                          "per_split_s": {sp: s for sp, _, s in splits}}
            print(f"[13b] extract-features --dtype {dtype}: {n_frames} frames in "
                  f"{wall:.2f} s (the command, encoders built and int8 calibrated "
                  f"included); encode {n_frames / enc_s:.1f} frames/s (imagenet_rn50 + "
                  f"clip_rn50, batch 256, the copies to and from the card included); the "
                  f"splits' seconds: encode {split_s['encode']:.3f}, labels "
                  f"{split_s['labels']:.3f}, npz write {split_s['write']:.3f}; launches "
                  f"{got}; {smi}")
            # the steady state: one warm 256-frame batch of both encoders, copies included
            batch = truth["train"][0][:256]
            probe = FS.FeatureStoreWriter(encoders, batch_size=256)
            probe.encode_frames(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            probe.encode_frames(batch)
            batch_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for enc in encoders.values():  # the features left on the card
                enc.encode(batch)
            torch.cuda.synchronize()
            on_card_s = time.perf_counter() - t0
            ext[dtype].update(steady_frames_per_s=256 / batch_s, steady_batch_ms=batch_s * 1e3,
                              steady_on_card_ms=on_card_s * 1e3)
            print(f"[13b] {dtype}: a warm 256-frame batch through both encoders, the copies "
                  f"included: {256 / batch_s:.1f} frames/s ({batch_s * 1e3:.1f} ms, of which "
                  f"{on_card_s * 1e3:.1f} ms the frames' copy in and the encodes, the rest "
                  f"the features' f32 casts and copies back); {smi}")
            if dtype == "int8":
                x = torch.from_numpy(truth["train"][0][:256]).to("cuda")
                ext[dtype]["calls_held"] = hold_rollout_calls(
                    encoders["clip_rn50"].encode, x, "int8", phase="13b")
            if dtype == "bfloat16":
                bf16_encoders = dict(encoders)
        feat_keys = FEATURE_KEYS
        cos = {}
        for dtype, limits in (("bfloat16", dict.fromkeys(feat_keys, COSINE_LIMIT)),
                              ("int8", {**INT8_COSINE_LIMITS, **IMAGENET_INT8_COSINE_LIMITS})):
            cos[dtype] = {k: max(cosine_distance(stores[dtype][sp][k], stores["float32"][sp][k])
                                 for sp in truth) for k in feat_keys}
            print(f"[13b] {dtype} store vs the f32 store, worst split, cosine: " + ", ".join(
                f"{k} {v:.3e} (limit {limits[k]:g})" for k, v in cos[dtype].items()))
            check(all(v <= limits[k] for k, v in cos[dtype].items()),
                  f"(b) {dtype} features within {limits}")
        out["extract"] = {**ext, "cosine_vs_f32": cos}

        # -- (c) the reachability store --------------------------------------------------
        import random as _random

        store = os.path.join(tmp, "bfloat16")
        base = golden_frames(32)
        names = [f"edge_{i:03d}" for i in range(256)]
        images = {n: np.ascontiguousarray(np.roll(base[i % 32], 11 * (i // 32), axis=1))
                  for i, n in enumerate(names)}
        t0 = time.perf_counter()
        writer = FS.FeatureStoreWriter(bf16_encoders, batch_size=256)
        writer.write_reachable_features(store, images)
        superset = sorted(TARGET_OBJECTS[:20])
        rng = _random.Random(0)
        triples = {}
        for split, (lo, hi) in (("train", (0, 160)), ("val", (160, 208)), ("test", (208, 256))):
            boxes = {n: {f"{superset[(i + j) % 20]}_{j}": [0, 0, 1, 1] for j in range(3)}
                     for i, n in enumerate(names[lo:hi], lo)}
            pick = {n: [o for j, o in enumerate(objs) if (7 * i + 3 * j) % 5 < 2]
                    for i, (n, objs) in enumerate(boxes.items(), lo)}
            triples[split] = build_split_triples(boxes, pick, superset, rng)
            FS.FeatureStoreWriter.write_reachable_split(store, split, triples[split])
        reach_s = time.perf_counter() - t0
        with np.load(os.path.join(store, "reachable_image_features.npz")) as z:
            feats = dict(zip(z["image_names"], z["clip_attnpool"]))
            check(set(z.files) == {"image_names", "imagenet_avgpool", "clip_avgpool",
                                   "clip_attnpool"}, "(c) pooled keys only")
        for split, tr in triples.items():
            x, (obj, reach) = load_probe_split(store, split, "clip_attnpool", "reachability")
            check(len(x) == len(tr) > 0 and all(np.array_equal(r, feats[t[0]])
                                                for r, t in zip(x, tr))
                  and obj.tolist() == [t[1] for t in tr]
                  and reach.tolist() == [int(t[2]) for t in tr],
                  f"(c) load_probe_split reads the {split} reachability store back")
        out["reachability"] = {"images": 256, "triples": {k: len(v) for k, v in triples.items()},
                               "seconds": reach_s}
        print(f"[13c] reachability store: 256 images (300×300) encoded and written in "
              f"{reach_s:.2f} s, triples {out['reachability']['triples']}, read back by "
              f"load_probe_split")

        # -- (d) probe-sweep, and the card against the CPU -------------------------------
        fits = []
        fit = SUP.ProbeTrainer.fit

        def timed_fit(self, dm):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fit(self, dm)
            torch.cuda.synchronize()
            fits.append({"entry": f"{self.cfg.prediction_type}/{self.cfg.embedding_type}",
                         "steps": self.global_step, "epochs": self.cfg.max_epochs,
                         "s": time.perf_counter() - t0})
            return res

        SUP.ProbeTrainer.fit = timed_fit
        try:
            code, text = run_cli(["probe-sweep", "--data-dir", store, "--max-epochs", "2",
                                  "--log-dir", os.path.join(tmp, "logs"),
                                  "--output", os.path.join(tmp, "sweep.json")])
            sweep = json.loads(text)
            check(code == 0 and len(sweep) == 11 and len(fits) == 11,
                  f"(d) probe-sweep ran the 11 probes ({len(sweep)})")
            check(all(np.isfinite(v["loss"]) for v in sweep.values()),
                  "(d) every test loss finite")
            sweep_rows = {}
            for f in fits:
                r = {"steps_per_s": f["steps"] / f["s"], "epoch_ms": f["s"] / f["epochs"] * 1e3,
                     "steps": f["steps"], "test": sweep[f["entry"]]}
                sweep_rows[f["entry"]] = r
                print(f"[13d] {f['entry']}: {f['steps']} steps in {f['s']:.3f} s, "
                      f"{r['steps_per_s']:.1f} steps/s, epoch {r['epoch_ms']:.1f} ms (2 "
                      f"validations included), test {r['test']}; {smi}")
            out["sweep"] = sweep_rows

            card_cpu = {}
            for pred, emb in PROBE_PAIRS:
                res = {}
                for device in ("cuda", "cpu"):
                    dm = ProbeDataModule(store, emb, pred).setup()
                    tr = SUP.ProbeTrainer(SUP.ProbeTrainConfig(
                        embedding_type=emb, prediction_type=pred, max_epochs=2,
                        device=device))
                    res[device] = (tr.fit(dm), tr.test(dm))
                dv = abs(res["cuda"][0]["loss"] - res["cpu"][0]["loss"])
                dt = abs(res["cuda"][1]["accuracy"] - res["cpu"][1]["accuracy"])
                card_cpu[f"{pred}/{emb}"] = {"val_loss_diff": dv, "test_metric_diff": dt}
                print(f"[13d] {pred}/{emb} after 2 epochs, card vs CPU (same initial "
                      f"params, TF32 off): |val loss diff| {dv:.3e}, |test metric diff| "
                      f"{dt:.3e} (limit {CARD_VS_CPU_LIMIT:g})")
                check(dv <= CARD_VS_CPU_LIMIT and dt <= CARD_VS_CPU_LIMIT,
                      f"(d) {pred}/{emb} on the card equals the CPU")
            out["card_vs_cpu"] = card_cpu

            # -- (e) the evaluation paths ------------------------------------------------
            common = ["--data-dir", store, "--embedding-type", "clip_avgpool",
                      "--prediction-type", "object_presence"]
            ck = os.path.join(tmp, "probe_ckpt")
            code, text = run_cli(["probe-train", *common, "--max-epochs", "2",
                                  "--log-dir", os.path.join(tmp, "logs"), "--ckpt-dir", ck])
            trained = json.loads(text)["test"]
            n_fits = len(fits)
            code_e, text = run_cli(["probe-train", *common, "--eval", "--ckpt",
                                    os.path.join(ck, "best.pt")])
            evaluated = json.loads(text)["test"]
            diff_e = max(abs(evaluated[k] - trained[k]) for k in ("loss", "accuracy"))
            check(code == code_e == 0 and len(fits) == n_fits and diff_e <= 1e-6,
                  f"(e) probe-train --eval --ckpt reproduces the test loss and metric "
                  f"({diff_e:.2e})")
            argv = ["train", "--config", "probe_object_presence_clip_avgpool", "--output-dir",
                    os.path.join(tmp, "exp"), "--override", f"data_dir={store}",
                    "max_epochs=2", f"log_dir={os.path.join(tmp, 'logs')}"]
            code, text = run_cli(argv)
            exp_trained = json.loads(text)["test"]
            n_fits = len(fits)
            code_e, text = run_cli(argv[:5] + ["--eval"] + argv[5:])
            exp_eval = json.loads(text)["test"]
            diff_x = abs(exp_eval["loss"] - exp_trained["loss"])
            check(code == code_e == 0 and len(fits) == n_fits and diff_x <= 1e-5,
                  f"(e) train --config probe_* --eval does not train and scores the best "
                  f"checkpoint ({diff_x:.2e})")
            out["eval_paths"] = {"probe_train_eval_diff": diff_e, "train_eval_loss_diff": diff_x}
            print(f"[13e] probe-train --eval --ckpt best.pt: test loss {evaluated['loss']:.6f}, "
                  f"metric {evaluated['accuracy']:.6f} vs the trained run's "
                  f"{trained['loss']:.6f}, {trained['accuracy']:.6f}; train --config "
                  f"probe_object_presence_clip_avgpool --eval: no fit, test loss "
                  f"{exp_eval['loss']:.6f} vs {exp_trained['loss']:.6f}")
        finally:
            SUP.ProbeTrainer.fit = fit

        # -- (f) one probe at the reference's full split sizes ---------------------------
        full = full_split_store(os.path.join(tmp, "full"))
        out["full_split"] = probe_full_split(full, smi, profile)

        # -- (g) verify-parity ----------------------------------------------------------
        out["verify_parity"] = check_verify_parity(tmp, smi, O, make_preprocessor)

        # -- (h) list-configs -----------------------------------------------------------
        res = subprocess.run([sys.executable, "-m", "embodied_clip_tpu_torch", "list-configs"],
                             capture_output=True, text=True, timeout=300,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        check(res.returncode == 0 and res.stdout.split() == list_experiments()
              and len(list_experiments()) == 29,
              f"(h) list-configs prints the 29 names ({len(res.stdout.split())})")
        print(f"[13h] python -m embodied_clip_tpu_torch list-configs: "
              f"{len(res.stdout.split())} names, those of list_experiments()")

        # -- (i) the data-parallel probe trainer -----------------------------------------
        out["data_parallel"] = check_probe_data_parallel(full)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def check_probe_data_parallel(full):
    """Phase 13 (i): where 2 cards are present, the data-parallel probe trainer in 2 NCCL
    processes (one card each) against one process on the `full` store: params within
    1e-6. Returns the distance, or None with one card."""
    import numpy as np
    import torch

    if torch.cuda.device_count() < 2:
        print(f"[13i] {torch.cuda.device_count()} card(s): the 2-process data-parallel "
              "probe trainer needs 2, not run")
        return None
    from embodied_clip_tpu_torch.parallel.dryrun import run_ranks

    single = probe_dp_rank(full, False)
    ranks = run_ranks(2, probe_dp_rank, full, True, device="cuda", timeout=600)
    dist = max(float(np.abs(p[k] - single[k]).max()) for p in ranks for k in single)
    check(dist <= 1e-6, f"(i) 2 NCCL processes equal one within 1e-6 ({dist:.2e})")
    print(f"[13i] data-parallel probe trainer on {torch.cuda.device_count()} cards, 2 NCCL "
          f"processes (one card each) vs one: params max |diff| {dist:.3e}")
    return {"processes": 2, "max_param_diff": dist}


def probe_dp_rank(data_dir, data_parallel):
    """Phase 13 (i): 2 epochs of the object-presence probe on the full-size store, the
    params as numpy arrays."""
    from embodied_clip_tpu_torch.data.probing import ProbeDataModule
    from embodied_clip_tpu_torch.training.supervised import ProbeTrainConfig, ProbeTrainer

    dm = ProbeDataModule(data_dir, "clip_avgpool", "object_presence").setup()
    tr = ProbeTrainer(ProbeTrainConfig(max_epochs=2, data_parallel=data_parallel))
    tr.fit(dm)
    return {k: v.cpu().numpy() for k, v in tr.params.items()}


def full_split_store(full):
    """A clip_avgpool / object_presence store at the reference's split sizes
    (`FULL_SPLIT`), its labels a fixed linear function of the features; returns `full`."""
    import numpy as np

    os.makedirs(full)
    rng = np.random.RandomState(0)
    w = rng.randn(2048, 52).astype(np.float32) / 2048 ** 0.5
    for split, n in FULL_SPLIT.items():
        x = np.abs(rng.randn(n, 2048)).astype(np.float32)
        np.savez(os.path.join(full, f"thor_{split}.npz"), clip_avgpool=x,
                 object_presence=(x @ w > 0.3).astype(np.int64))
    return full


def probe_full_split(full, smi, profile):
    """Phase 13 (f): 5 epochs of the object-presence probe on a 6,000/750/750-frame
    clip_avgpool store. Each step is timed by host clock and by CUDA events around the
    `probe_train_step` call; an epoch by host clock with the card synchronized."""
    import numpy as np
    import torch

    from embodied_clip_tpu_torch.data.probing import ProbeDataModule
    from embodied_clip_tpu_torch.training import supervised as SUP

    step = SUP.probe_train_step
    host, spans = [], []

    def timed_step(*args, **kw):
        t0 = time.perf_counter()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss = step(*args, **kw)
        b.record()
        host.append(time.perf_counter() - t0)
        spans.append((a, b))
        return loss

    dm = ProbeDataModule(full, "clip_avgpool", "object_presence").setup()
    epochs = 5
    tr = SUP.ProbeTrainer(SUP.ProbeTrainConfig(max_epochs=1))
    SUP.probe_train_step = timed_step
    epoch_ms = []
    try:
        for _ in range(epochs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.fit(dm)
            torch.cuda.synchronize()
            epoch_ms.append((time.perf_counter() - t0) * 1e3)
        busy = None
        if profile:
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as torch_profile

            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                tr.fit(dm)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            busy = busy_ms(prof) / wall
    finally:
        SUP.probe_train_step = step
    steps = dm.steps_per_epoch("train")
    check(steps == 47 and tr.global_step >= epochs * steps, f"(f) {steps} steps an epoch")
    test = tr.test(dm)
    check(np.isfinite(test["loss"]), "(f) test loss finite")
    n = epochs * steps
    step_ms = sum(a.elapsed_time(b) for a, b in spans[:n]) / n
    host_ms = sum(host[:n]) / n * 1e3
    res = {"steps_per_epoch": steps, "epochs": epochs, "step_ms_events": step_ms,
           "host_ms_per_step": host_ms, "epoch_ms": epoch_ms,
           "epoch_ms_min": min(epoch_ms), "device_busy_share": busy, "test": test,
           "train_mb": 6000 * 2048 * 4 / 2 ** 20}
    print(f"[13f] object_presence/clip_avgpool at the reference's split sizes (6000/750/750, "
          f"{res['train_mb']:.0f} MiB of train features), batch 128, {steps} steps an epoch: "
          f"{step_ms:.4f} ms a step (CUDA events around the step call), host "
          f"{host_ms:.4f} ms a step, epoch {min(epoch_ms):.1f} ms (best of {epochs}; 2 "
          f"validations included), test {test}"
          + (f", device busy {busy:.1%} of an epoch (profiled)" if busy is not None else "")
          + f"; the reference trains 250 epochs; {smi}")
    return res


def check_verify_parity(tmp, smi, O, make_preprocessor):
    """Phase 13 (g): `verify-parity` against activations of oracle checkpoints (the
    reference's state_dict layouts, torch seed 7) captured here in the `.npz` layout of
    tools/capture_reference_activations.py (`__frames__`, conv maps NCHW) from the port's
    plain f32 preprocess and the oracle in f32 on the card."""
    import numpy as np
    import torch

    from embodied_clip_tpu_torch.parity import golden_frames

    frames = golden_frames(8)
    paths = {}
    for name, family, make in (
            ("clip_rn50", "clip", lambda: O.ModifiedResNetOracle((3, 4, 6, 3), 64, 32, 1024, 224)),
            ("imagenet_rn18", "imagenet", lambda: O.TVResNetTrunk((2, 2, 2, 2), block="basic"))):
        for seed in (7, 8):
            torch.manual_seed(seed)
            model = make().eval()
            ck = os.path.join(tmp, f"{name}_seed{seed}.pt")
            torch.save(model.state_dict(), ck)
            paths[name, seed] = ck
        torch.manual_seed(7)
        model = make().eval().to("cuda")
        x = make_preprocessor(family, 224, torch.float32)(
            torch.from_numpy(frames).to("cuda")).permute(0, 3, 1, 2).contiguous()
        with torch.no_grad():
            if family == "clip":
                conv = model.trunk(x).float()
                acts = {"clip_conv": conv, "clip_avgpool": conv.mean(dim=(2, 3)),
                        "clip_attnpool": model.attnpool(conv).float()}
            else:
                conv = model(x).float()
                acts = {"imagenet_conv": conv, "imagenet_avgpool": conv.mean(dim=(2, 3))}
        path = os.path.join(tmp, f"{name}_acts.npz")
        np.savez_compressed(path, __frames__=frames,
                            **{k: v.cpu().numpy() for k, v in acts.items()})
        paths[name, "acts"] = path

    def verify(name, *more):
        code, text = run_cli(["verify-parity", "--encoder", name, "--activations",
                              paths[name, "acts"], *more])
        return code, json.loads(text)

    res = {}
    for name, runs in VERIFY_THRESHOLDS.items():
        for dtype, threshold in runs.items():
            (code, r), got = launches_of(lambda: verify(
                name, "--torch-checkpoint", paths[name, 7], "--dtype", dtype,
                "--threshold", str(threshold)))
            res[f"{name}/{dtype}"] = {"per_key": r["per_key_cosine_distance"],
                                      "threshold": threshold, "launches": got}
            print(f"[13g] verify-parity {name} --dtype {dtype}: worst {r['worst']:.3e} "
                  f"(threshold {threshold:g}), per key " + ", ".join(
                      f"{k} {v:.3e}" for k, v in r["per_key_cosine_distance"].items())
                  + f"; launches {got}")
            check(code == 0 and r["pass"], f"(g) verify-parity {name} {dtype} passes")
    sub = subprocess.run([sys.executable, "-m", "embodied_clip_tpu_torch", "verify-parity",
                          "--encoder", "clip_rn50", "--activations", paths["clip_rn50", "acts"],
                          "--torch-checkpoint", paths["clip_rn50", 7], "--dtype", "bfloat16"],
                         capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    check(sub.returncode == 0, f"(g) python -m embodied_clip_tpu_torch verify-parity exits 0: "
                               f"{sub.stderr[-2000:]}")
    code, bad = verify("clip_rn50", "--torch-checkpoint", paths["clip_rn50", 8])
    check(code == 1 and not bad["pass"], f"(g) another seed's checkpoint fails, exit {code}")
    print(f"[13g] python -m embodied_clip_tpu_torch verify-parity (bf16) in a subprocess: "
          f"exit 0; against seed 8's checkpoint: exit {code}, worst {bad['worst']:.3e}")
    conv_res = {}
    for fold in (False, True):
        sd = os.path.join(tmp, f"clip_rn50_converted_{fold}.pt")
        code, _ = run_cli(["convert-weights", "--torch-checkpoint", paths["clip_rn50", 7],
                           "--encoder", "clip_rn50", "--output", sd]
                          + (["--fold-bn"] if fold else []))
        check(code == 0, "(g) convert-weights exits 0")
        code, r = verify("clip_rn50", "--variables", sd)
        want = res["clip_rn50/float32"]["per_key"]
        got = r["per_key_cosine_distance"]
        diff = max(abs(got[k] - want[k]) for k in want)
        if fold:  # BN folded in f32: the same distances up to the fold's rounding
            ok = all(abs(got[k] - want[k]) <= 1e-9 + 1e-2 * want[k] for k in want)
        else:
            ok = got == want
        check(code == 0 and r["pass"] and ok,
              f"(g) verify-parity --variables of convert-weights{' --fold-bn' * fold}: "
              f"distances {got} vs {want}")
        conv_res["folded" if fold else "plain"] = {"per_key": got, "max_diff": diff}
        print(f"[13g] convert-weights{' --fold-bn' if fold else ''} → verify-parity "
              f"--variables (f32): worst {r['worst']:.3e}, max |distance diff| vs "
              f"--torch-checkpoint {diff:.3e}")
    res["converted"] = conv_res
    res["wrong_checkpoint_worst"] = bad["worst"]
    return res


# -- phase 14: the JAX package's int8 graph options -------------------------------------

# int4 stage 1 vs f32, every key: the JAX package's own envelope (tests/test_quantize.py:121).
# The reciprocal requant and the int8 stems keep INT8_COSINE_LIMITS: on the seed-0
# clip_rn50 weights the JAX package's own distances under them are ≤1.842e-3 (conv map)
# and ≤1.14e-4 (pooled), inside those limits, and int4's ≤2.35e-2
# (tests/test_torch_quant_variants.py::test_rn50_int8_option_fidelity_matches_jax).
INT4_COSINE_LIMIT = 5e-2
# Launches per batch-128 encode of each option (phase 14 (b)); the int8 stems leave stem12
# and K2 out and run their s8 convs through `conv3x3_int8` (stem3; stem2 and stem3 under
# "full").
_A = {"fused_preprocess": 1, "fused_stage1_int8": 1, "fused_resblocks_int8": 3,
      "fused_stride_block_int8": 3}
OPTION_LAUNCHES = {
    "A": {**_A, "stem12_f32": 1, "stem3_requant_pool_int8": 1},
    "A recip": {**_A, "stem12_f32": 1, "stem3_requant_pool_int8": 1},
    "stem3": {**_A, "conv3x3_int8": 1},
    "full": {**_A, "conv3x3_int8": 2},
    "B recip": {"fused_preprocess": 1, "stem12_f32": 1, "stem3_requant_pool_int8": 1,
                "fused_stage1_int8": 1,
                "fused_cb3_cb1_int8": 12, "fused_stride_block_int8": 3},
    "plain": {"fused_preprocess": 1},
    "int4 1": {"fused_preprocess": 1},
    "int4 2": {"fused_preprocess": 1}}


def check_recip_kernels(qenc, frames, card):
    """Phase 14 (a): every K2-K5 and stride-block call of a batch-128 encode on paths A
    and B in the reciprocal form, held to its plain version in that form with phase 5's
    contracts; each call timed in both forms (in turns: reciprocal, division, division,
    reciprocal) by phase 5's method, and the s8 difference of the two forms (≤0.5% of
    elements; ≤1 step where one requant makes the output). Each kernel takes the
    reciprocal form where its TPU kernel calls `_unscale`, the stride block at all four
    of its requants, as the XLA graph (ops/kernels/bottleneck_kernel.py). The stride
    block's row sums path A's calls; path B's are held too."""
    import torch

    from embodied_clip_tpu_torch.ops import quantize as Q
    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
    from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK

    recs = record_int8_calls({"A": qenc.with_kernels(recip_requant=True),
                              "B": qenc.with_kernels(**Q.PATH_B, recip_requant=True)}, frames)
    for args, kw, _ in recs["fused_stride_block_int8"]["B"]:
        check(kw.get("recip") is True, "path B's stride blocks in the reciprocal form")
        hold_int8_call(BK, "fused_stride_block_int8", args, kw)
    results = {}
    for name, path in INT8_KERNELS.items():
        if name == "stem12_f32":  # no requant: phase 5 holds it
            continue
        mod = SK if name.startswith("stem") else BK
        fn = getattr(mod, name)
        calls = recs.get(name, {}).get(path, [])
        check(len(calls) > 0 and all(kw.get("recip") is True for _, kw, _ in calls),
              f"{name} ran in the reciprocal form")
        t = dict.fromkeys(("ms", "device_ms", "division_ms", "division_device_ms",
                           "bound_ms"), 0.0)
        worst_step, worst_share, form_step, form_share = 0, 0.0, 0, 0.0
        for args, kw, _ in calls:
            step, share = hold_int8_call(mod, name, args, kw)
            worst_step, worst_share = max(worst_step, step), max(worst_share, share)
            div = {**kw, "recip": False}
            got, want = fn(*args, **kw), fn(*args, **div)
            pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
            for i, (g, w) in enumerate(pairs):
                d = (g.int() - w.int()).abs()
                step, share = int(d.max()), float((d != 0).float().mean())
                # One requant in that form (K2's before its pool, K4's block output, K5's
                # s8 output) moves ≤1 step; the outputs of chained ones (K4's next cb1,
                # K3's third block output) carry a flipped step through later convs.
                single = name in ("stem3_requant_pool_int8", "fused_resblocks_int8") or (
                    name == "fused_cb3_cb1_int8" and i == 0)
                check(share <= STEP_SHARE_LIMIT and (step <= 1 or not single),
                      f"{name}: the two requant forms {step} steps apart on {share:.2e}")
                form_step, form_share = max(form_step, step), max(form_share, share)
            ms = {True: [], False: []}
            for recip in (True, False, False, True):
                kwf = kw if recip else div
                ms[recip].append(cuda_ms(lambda: fn(*args, **kwf), 10))
            t["ms"] += min(ms[True])
            t["division_ms"] += min(ms[False])
            t["device_ms"] += graph_ms(lambda: fn(*args, **kw))
            t["division_device_ms"] += graph_ms(lambda: fn(*args, **div))
            t["bound_ms"] += bound(int8_work(name, args, kw, got), card)[0]
        contract = (f"≤{STEP_LIMIT} step on ≤{STEP_SHARE_LIMIT:g}: worst {worst_step} step on "
                    f"{worst_share:.2e}" if name in STEP_KERNELS else "bit-exact")
        if name == "fused_stride_block_int8":
            contract = f"o8 and cb3 bit-exact, id8 and the output {contract}"
        print(f"[14a] {name}, reciprocal requant: {len(calls)} call(s) per batch-128 encode; "
              f"vs its plain version in that form {contract}; kernel {t['ms']:.4f} ms "
              f"({t['device_ms']:.4f} on the device) against the division's "
              f"{t['division_ms']:.4f} ({t['division_device_ms']:.4f}), bound "
              f"{t['bound_ms']:.4f} ms; the two forms' s8 outputs {form_step} step apart on "
              f"{form_share:.2e} of elements")
        results[name] = {**t, "max_abs_err": float(worst_step), "share_differing": worst_share,
                         "vs_division": {"max_step": form_step, "share": form_share},
                         "calls": len(calls)}
    return results


def check_int8_options(qenc, iqenc, iref, f32_ref, g8, g128, x128, card, smi):
    """Phase 14: the JAX package's int8 graph options at full width (see main's docstring)."""
    import torch

    from embodied_clip_tpu_torch.models.encoders import build_encoder
    from embodied_clip_tpu_torch.ops import quantize as Q
    from embodied_clip_tpu_torch.ops.int8 import full_f32
    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
    from embodied_clip_tpu_torch.parity import cosine_distance, golden_frames

    tests_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests_dir not in sys.path:
        sys.path.insert(0, tests_dir)
    import torch_int8_cases as C8

    out = {"kernels": check_recip_kernels(qenc, g128, card)}

    # (b) batch-128 encodes of clip_rn50 under each option, in turns.
    variants = {"A": qenc, "A recip": qenc.with_kernels(recip_requant=True),
                "stem3": qenc.with_kernels(int8_stem="stem3"),
                "full": qenc.with_kernels(int8_stem="full"),
                "B recip": qenc.with_kernels(**Q.PATH_B, recip_requant=True),
                "plain": qenc.with_kernels(**Q.KERNELS_OFF),
                "int4 1": qenc.with_kernels(**Q.KERNELS_OFF, int4_stage1=1),
                "int4 2": qenc.with_kernels(**Q.KERNELS_OFF, int4_stage1=2)}
    rows = {}
    for label, enc in variants.items():
        _, got = launches_of(lambda: enc.encode(x128))
        check(got == OPTION_LAUNCHES[label], f"{label}: launches {got}, expected "
                                            f"{OPTION_LAUNCHES[label]}")
        feats = enc.encode(g8)
        cos = {k: cosine_distance(feats[k], f32_ref[k]) for k in f32_ref}
        limits = (dict.fromkeys(f32_ref, INT4_COSINE_LIMIT) if label.startswith("int4")
                  else INT8_COSINE_LIMITS)
        check(all(v <= limits[k] for k, v in cos.items()), f"{label}: cosine {cos} within "
                                                            f"{limits}")
        rows[label] = {"launches": got, "cosine_vs_f32": cos, "ms": []}
    for label in list(variants) + list(reversed(variants)):
        rows[label]["ms"].append(cuda_ms(lambda: variants[label].encode(x128), 5))
    # The int8 stems' s8 convs go through conv3x3_int8: each call held bit-exactly.
    for label in ("stem3", "full"):
        with Recorder(BK, "conv3x3_int8") as rc:
            variants[label].encode(x128)
            torch.cuda.synchronize()
        for args, kw, _ in rc.calls:
            hold_int8_call(BK, "conv3x3_int8", args, kw)
        rows[label]["conv3x3_int8_calls_held"] = [list(a[0].shape) for a, _, _ in rc.calls]
    for label, r in rows.items():
        ms = ", ".join(f"{m:.3f}" for m in r["ms"])
        print(f"[14b] clip_rn50 int8 {label}: batch-128 encode {ms} ms; launches "
              f"{r['launches']}; vs f32 (TF32 off) on golden_frames(8): "
              + ", ".join(f"{k} {v:.3e}" for k, v in r["cosine_vs_f32"].items()) + f"; {smi}")
    out["clip_rn50"] = rows

    # (c) ViT-B/32 int8: bf16 attention denses, the reciprocal form.
    vit = build_encoder("clip_vit_b32", dtype=torch.bfloat16, device="cuda")
    with full_f32():
        vref = build_encoder("clip_vit_b32", dtype=torch.float32,
                             device="cuda").encode(g8)["clip_embed"]
    qv = vit.quantize(golden_frames(32))
    vforms = {"s8": qv, "quant_attn=False": qv.with_kernels(quant_attn=False),
              "recip": qv.with_kernels(recip_requant=True)}
    vrows = {label: {"cosine_vs_f32": cosine_distance(e.encode(g8)["clip_embed"], vref),
                     "ms": []} for label, e in vforms.items()}
    for label in list(vforms) + list(reversed(vforms)):
        vrows[label]["ms"].append(cuda_ms(lambda: vforms[label].encode(x128), 5))
    for label, r in vrows.items():
        print(f"[14c] clip_vit_b32 int8 {label}: batch-128 encode "
              f"{', '.join(f'{m:.3f}' for m in r['ms'])} ms; clip_embed vs f32 (TF32 off) "
              f"{r['cosine_vs_f32']:.3e} (limit {VIT_INT8_COSINE_LIMIT:g}); {smi}")
        check(r["cosine_vs_f32"] <= VIT_INT8_COSINE_LIMIT, f"ViT {label} within the limit")
    check(vrows["quant_attn=False"]["cosine_vs_f32"] <= vrows["s8"]["cosine_vs_f32"] + 1e-6,
          "the bf16 attention denses no farther from f32 than all-s8")
    out["clip_vit_b32"] = vrows

    # (d) imagenet_rn50 int8 with the repaired stem and shortcut convs, in both forms; the
    # graph they replace (bf16-rounded stem and `down` outputs) beside it.
    fp_conv = Q._fp_conv
    irows = {}
    for label, enc in (("repaired", iqenc), ("repaired, recip", iqenc.with_kernels(
            recip_requant=True)), ("bf16-rounded stem and down (before)", iqenc)):
        if label.endswith("(before)"):
            Q._fp_conv = C8.bf16_rounded_conv
        try:
            feats = enc.encode(g8)
            ms = cuda_ms(lambda: enc.encode(x128), 5)
        finally:
            Q._fp_conv = fp_conv
        cos = {k: cosine_distance(feats[k], iref[k]) for k in iref}
        irows[label] = {"cosine_vs_f32": cos, "ms": ms}
        print(f"[14d] imagenet_rn50 int8, {label}: vs f32 " + ", ".join(
            f"{k} {v:.3e} (limit {IMAGENET_INT8_COSINE_LIMITS[k]:g})" for k, v in cos.items())
            + f"; batch-128 encode {ms:.3f} ms; {smi}")
        if not label.endswith("(before)"):
            check(all(v <= IMAGENET_INT8_COSINE_LIMITS[k] for k, v in cos.items()),
                  f"imagenet_rn50 int8 {label} within {IMAGENET_INT8_COSINE_LIMITS}")
    out["imagenet_rn50"] = irows
    return out


def stride_block_sass(sass: str, log: str) -> None:
    """Phase 2: the stride blocks' launches in `bottleneck_int8`'s SASS: the pool (f)
    moves 16 bytes a thread each way (128-bit loads and stores); the shortcut (e) runs on
    bf16 wgmma with both operands from shared memory (every HGMMA takes A by descriptor,
    `gdesc[…]`, where K3's entry takes it from registers) and holds no float → bf16
    conversion (F2FP), which is (f')'s, once per element. Prints the shortcut's registers
    and spills from ptxas's report in the build log."""
    import re

    funcs = {f.splitlines()[0]: f for f in sass.split("Function : ")[1:]}

    def of(name):
        return [f for k, f in funcs.items() if name in k]

    def hgmma(f):
        return [ln.strip() for ln in f.splitlines() if "HGMMA." in ln]

    pool, shortcut, scale, entry = (of(n) for n in ("avg_pool2_s8_kernel", "shortcut_kernel",
                                                    "pool2_scale_kernel", "entry_kernel"))
    wide = [sum(1 for ln in f.splitlines() if op in ln and ".128" in ln)
            for f in pool for op in ("LDG", "STG")]
    ss = re.compile(r"HGMMA\.\S+\s+R\d+\s*,\s*gdesc\[")
    lines = [hgmma(f) for f in shortcut]
    print(f"[2] bottleneck_int8 SASS: the 2x2 pool kernel's 128-bit loads, stores {wide}; "
          f"the stride shortcut's {len(shortcut)} instantiations hold "
          f"{[len(x) for x in lines]} HGMMA, "
          f"{[sum(bool(ss.search(ln)) for ln in x) for x in lines]} of them with A from "
          f"shared memory, {[f.count('F2FP') for f in shortcut]} F2FP; the pool + scale "
          f"kernel {[f.count('F2FP') for f in scale]} F2FP")
    for label, fs in (("stride shortcut (e)", shortcut), ("K3 entry (d)", entry)):
        if fs and hgmma(fs[0]):
            print(f"[2]   {label}, an HGMMA: {hgmma(fs[0])[0]}")
    check(len(pool) == 1 and wide[0] >= 4 and wide[1] >= 1,
          "the 2x2 pool kernel loads and stores 16 bytes a thread")
    check(len(shortcut) == 2 and all(x and all(ss.search(ln) for ln in x) for x in lines),
          "the stride shortcut runs on bf16 wgmma with both operands from shared memory")
    check(all("F2FP" not in f for f in shortcut) and len(scale) == 1 and "F2FP" in scale[0],
          "the stride shortcut converts nothing to bf16; the pool + scale kernel does, once")
    name, report = None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and "shortcut_kernel" in name and ("spill" in line or "Used" in line):
            report.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    for k, v in report.items():
        print(f"[2]   ptxas, {k}: {'; '.join(v)}")
    check(len(report) == 2, "ptxas reported the stride shortcut's registers and spills")


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
    # its input bands with the 1-D bulk copy (UBLKCP); the attention launch runs both
    # products on bf16 wgmma.
    for src, wants, banned in (("bottleneck_bf16", ("HGMMA.",), "HMMA."),
                               ("stem_int8", ("HGMMA.",), "HMMA."),
                               ("bottleneck_int8", ("IGMMA", "HGMMA."), "IDP.4A"),
                               ("preprocess", ("UBLKCP",), None),
                               ("attention_bf16", ("HGMMA.",), "HMMA.")):
        sass = subprocess.run([shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump",
                               "-sass", str(_build.library_path(src))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        counts = {w: sass.count(w) for w in wants}
        n_banned = sass.count(banned) if banned else 0
        print(f"[2] {src} SASS: " + ", ".join(f"{n} {w.rstrip('.')}" for w, n in counts.items())
              + " instructions" + (f", {n_banned} {banned.rstrip('.')}" if banned else ""))
        check(all(counts.values()) and n_banned == 0,
              f"{src} holds {', '.join(wants)}" + (f" and no {banned}" if banned else ""))
        if src == "bottleneck_int8":
            stride_block_sass(sass, _build.build_log(src))

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
    enc = build_encoder("clip_rn50", dtype=torch.bfloat16, device="cuda").fold_bn()
    rng = np.random.RandomState(1)
    reqs = []
    for n, layout in REQUESTS:
        f = rng.randint(0, 256, (n, 300, 300, 3), np.uint8)
        reqs.append(f.reshape(n, 300, 900) if layout == "flat" else f)
    bf16_counted = {"fused_preprocess": K.fused_preprocess, "fused_stage1": BK.fused_stage1,
                    "fused_bottleneck": BK.fused_bottleneck,
                    "fused_stride_block_bf16": BK.fused_stride_block_bf16}

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

    x128 = torch.from_numpy(reqs[-1]).to(dev)
    clip_times = encode_times({"bf16 folded (K6/K7)": enc}, "4", "clip_rn50")
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
               "stem12_f32": SK.stem12_f32,
               "stem3_requant_pool_int8": SK.stem3_requant_pool_int8,
               "fused_stage1_int8": BK.fused_stage1_int8,
               "fused_resblocks_int8": BK.fused_resblocks_int8,
               "fused_cb3_cb1_int8": BK.fused_cb3_cb1_int8,
               "fused_stride_block_int8": BK.fused_stride_block_int8}
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
    # Path A with the stride blocks on plain torch (kernel_stride_blocks=False), in turns
    # with the default on the same weights; and the default's calls of the library's s8
    # route during one encode (ops/int8.qmm = torch._int_mm, im2col3x3): none.
    route_ms = encode_times({"path A": qenc,
                             "path A, kernel_stride_blocks=False": qenc.with_kernels(
                                 kernel_stride_blocks=False)}, "6", "clip_rn50 int8")
    library_calls = library_s8_calls(lambda: qenc.encode(x128))
    print(f"[6A] calls of ops/int8.qmm and im2col3x3 during one path A encode: "
          f"{library_calls}")
    check(library_calls == {"qmm": 0, "im2col3x3": 0},
          f"path A makes no qmm or im2col3x3 call: {library_calls}")

    # -- 7. K6/K7 against their plain versions on batch-128 main-path inputs -------------
    ienc = build_encoder("imagenet_rn50", dtype=torch.bfloat16, device="cuda").fold_bn()
    with torch.inference_mode():
        bf16_results = check_bf16_kernels({"clip_rn50": enc, "imagenet_rn50": ienc}, g128,
                                          card)

    # -- 8. the ImageNet family: bf16 folded rn50/rn18, then rn50 int8 --------------------
    imagenet_launches, imagenet_ms, imagenet_cos = {}, {}, {}
    for model, folded in (("imagenet_rn50", ienc), ("imagenet_rn18", None)):
        folded = folded or build_encoder(model, dtype=torch.bfloat16, device="cuda").fold_bn()
        imagenet_launches[model] = serve_bf16(folded, "8", model)
        ref = build_encoder(model, dtype=torch.float32, device="cuda").encode(g8)
        imagenet_cos[model] = fidelity(folded, ref, f"8 {model} bf16 folded",
                                       dict.fromkeys(ref, COSINE_LIMIT))
        if model == "imagenet_rn50":
            iref = ref
        imagenet_ms[model] = encode_times({"bf16 folded": folded}, "8", model)
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

    # -- 11. the CLIP transformer family: ViT-B/32 serving, the dual towers, zero-shot
    # ObjectNav; one clip_rn50x16 request in bf16 and int8 ------------------------------
    vit = check_vit(card, smi, reqs, x128)
    towers, rn50_table = check_clip_towers(smi)
    zeroshot = check_zeroshot(card, smi, rn50_table)
    rn50x16 = check_rn50x16(card, smi)

    # -- 12. the RL experiment registry: train, resume and evaluate through get_experiment
    registry = check_registry(card, smi)

    # -- 13. the probing stack: extraction, the probe trainer and its grid, verify-parity
    probing = check_probing(card, smi, profile)

    # -- 14. the JAX package's int8 graph options ------------------------------------------
    t0 = time.perf_counter()
    options = check_int8_options(qenc, iqenc, iref, f32_ref, g8, g128, x128, card, smi)
    print(f"[14] phase 14 took {time.perf_counter() - t0:.1f} s")

    # -- 15. the fused attention launch ----------------------------------------------------
    attention = check_attention(card, smi)

    # -- 16. the per-element launches of the ViT blocks -------------------------------------
    pointwise = check_pointwise(card, smi)

    # -- 17. results ---------------------------------------------------------------------
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
    rows.append({"name": "stem12_f32", "route": "cuda", "source": src + "stem_int8.cu",
                 "replaces": "embodied_clip_tpu/ops/quantize.py:445-493 (no TPU kernel: XLA's "
                             "f32 stem1 and stem2 convs)", "tpu_kernel": None,
                 "launches": path_launches["A"]["stem12_f32"], "path": "A",
                 **int8_results["stem12_f32"], "ms_unit": "per batch-128 encode"})
    sb = int8_results["fused_stride_block_int8"]
    rows.append({"name": "fused_stride_block_int8", "route": "cuda",
                 "source": src + "bottleneck_int8.cu",
                 "replaces": "embodied_clip_tpu/ops/quantize.py:431 (no TPU kernel: XLA's s8 "
                             "convolutions; the block at :545-609)", "tpu_kernel": None,
                 "launches": path_launches["A"]["fused_stride_block_int8"], "path": "A",
                 "launches_path_b": path_launches["B"]["fused_stride_block_int8"], **sb,
                 "ms_unit": "per batch-128 encode (all calls)"})
    for name, replaces in (("fused_bottleneck", pallas + "bottleneck_kernel.py:81"),
                           ("fused_stage1", pallas + "bottleneck_kernel.py:164"),
                           ("fused_stride_block_bf16",
                            "embodied_clip_tpu/models/clip_resnet.py:70 (no TPU kernel: "
                            "XLA's convolutions and avg_pool; the stride-2 block)")):
        r = bf16_results[name]
        extra = ({"launch_kinds": bf16_results["stride_parts"]["launch_kinds"]}
                 if name == "fused_stride_block_bf16" else {})
        rows.append({"name": name, "route": "cuda", "source": src + "bottleneck_bf16.cu",
                     "replaces": replaces, "launches": bf16_launches[name], **extra,
                     "launches_imagenet_rn50": imagenet_launches["imagenet_rn50"][name],
                     "max_abs_err": r["max_abs_err"], "share_differing": r["share"],
                     "worst_of_allowance": r["worst"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": max(r["by"], key=r["by"].get),
                     "cudnn_route_ms": r["cudnn_route_ms"], "library_ms": None,
                     "ms_unit": "per batch-128 clip_rn50 encode (all calls)",
                     "calls": r["calls"]})
    for row in rows:
        name = row["name"]
        row["launches_option_encode"] = {label: r["launches"].get(name, 0)
                                         for label, r in options["clip_rn50"].items()}
        if name in options["kernels"]:
            row["recip"] = options["kernels"][name]
    print(json.dumps({"encode_ms_batch128": {"clip_rn50": {**clip_times, "int8_path_a": ms_a,
                                                           "int8_path_a_again": ms_a2,
                                                           "int8_path_b": ms_b,
                                                           "int8_path_a_in_turns": route_ms},
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
    rn50x16_launches = {**rn50x16["bf16"]["launches"], **rn50x16["int8"]["launches"]}
    for row in rows:
        name = row["name"]
        row["launches_vit_request"] = vit["launches_per_request"]["bf16"].get(name, 0)
        row["launches_vit_int8_request"] = vit["launches_per_request"]["int8"].get(name, 0)
        row["launches_zeroshot_iteration"] = zeroshot["launches"].get(name, 0)
        if name in zeroshot["rollout_calls_held"]:
            row["zeroshot_rollout_calls_held"] = zeroshot["rollout_calls_held"][name]
        row["launches_rn50x16_request"] = rn50x16_launches.get(name, 0)
        for label in ("bf16", "int8"):
            if name in rn50x16[label]["calls_held"]:
                row["rn50x16_calls_held"] = rn50x16[label]["calls_held"][name]
    for row in rows:
        name = row["name"]
        row["launches_registry_iteration"] = registry["a"]["launches_per_iteration"].get(name, 0)
        row["launches_registry_int8_iteration"] = \
            registry["b"]["launches_per_iteration"].get(name, 0)
        if name in registry["b"]["rollout_calls_held"]:
            row["registry_rollout_calls_held"] = registry["b"]["rollout_calls_held"][name]
    for row in rows:
        row["launches_extraction_batch"] = {}
        for dtype in ("bfloat16", "int8"):
            e = probing["extract"][dtype]
            calib = 2 if dtype == "int8" and row["name"] == "fused_preprocess" else 0
            row["launches_extraction_batch"][dtype] = \
                (e["launches"].get(row["name"], 0) - calib) // e["batches"]
        if row["name"] in probing["extract"]["int8"]["calls_held"]:
            row["extraction_calls_held"] = probing["extract"]["int8"]["calls_held"][row["name"]]
    rows[0]["host_act_step_shape"] = host["k1_act_step_shape"]  # K1
    rows[0]["host_habitat_shape"] = host["k1_habitat_shape"]
    rows[0]["zeroshot_rollout_shape"] = zeroshot["k1_rollout_shape"]
    print(json.dumps({"ddppo": {k: v for k, v in ddppo.items() if k != "k1_rollout_shape"},
                      "card": smi}))
    print(json.dumps({"host": {k: v for k, v in host.items()
                               if k not in ("k1_act_step_shape", "k1_habitat_shape")},
                      "card": smi}))
    print(json.dumps({"clip_family": {
        "vit_b32": vit, "towers": towers,
        "zeroshot": {k: v for k, v in zeroshot.items() if k != "k1_rollout_shape"},
        "rn50x16": rn50x16}, "card": smi}))
    print(json.dumps({"registry": registry}))
    print(json.dumps({"probing": probing}))
    print(json.dumps({"int8_options": {k: v for k, v in options.items() if k != "kernels"},
                      "card": smi}))
    print(json.dumps({"attention": attention, "card": smi}))
    print(json.dumps({"pointwise": pointwise, "card": smi}))
    check(not descendants(), f"every process the script started has ended, left: "
                             f"{descendants()}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
