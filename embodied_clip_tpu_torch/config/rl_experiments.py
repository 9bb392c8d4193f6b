"""RL experiment configs: the reference's documented experiment grid as registered
dataclasses (port of `embodied_clip_tpu/config/rl_experiments.py`, SURVEY.md §5 config
consolidation).

Name parity with the reference runbooks:
  objectnav_robothor_rgb_{clipresnet50,resnet50,resnet18,clipresnet50x16}gru_ddppo
      (baselines_robothor_objectnav.md:48-51; imagenet_vs_objectnav.md:6-11)
  zeroshot_objectnav_robothor_rgb_clipresnet50gru_ddppo[_eval]
      (zeroshot_objectnav.md:17-28)
  ddppo_{objectnav,pointnav}_rgb_{clip,imagenet}, ddppo_objectnav_{rgb,rgbd}
      (baselines_habitat.md:63-75; the suffix-less forms train from scratch)
  one_phase_rgb_{clipresnet50,resnet50}_dagger
      (baselines_ithor_rearrangement.md:8-12)
  two_phase_rgb_{clipresnet50,resnet50}_dagger
      (walkthrough→unshuffle, baselines_ithor_rearrangement.md:4-6)

Each experiment trains on one of four backends:
  fake      the batched on-device gridworld (default; runs anywhere, incl. CI)
  thor      AI2-THOR via envs/thor.py inside a VectorEnv pool (needs ai2thor, or a
            Controller-compatible `controller_factory`)
  habitat   habitat-lab via envs/habitat.py (needs habitat-sim)
  hostgrid  the host gridworld in a VectorEnv pool (host path without a simulator)
The card's side (frozen encoder + policy + DD-PPO/DAgger update) is the same across
backends; only rollout collection differs (on the device vs a host pool). Everything
runs on `device` ("cuda" unless the caller asks for "cpu").

Where the port differs from the JAX package:
  - torch modules take their input widths when built, so `_make_policy` takes the
    per-sample `visual_shape` of the policy's visual input (flax infers it).
  - The step checkpoints of the fake backend hold the policy's state_dict, the
    optimizer's state (`ClippedAdam.state_dict`), the act carry `ActState` flattened
    to tensors, and the `torch.Generator`'s state (the JAX act carry holds its PRNG
    key), one entry a process for the last two: a resumed run is bitwise the
    uninterrupted one. DAgger's aggregate buffer is not saved, as in the JAX package,
    so a resumed DAgger run is not.
  - Data parallelism is one process per card in a torch.distributed group, whose size
    `train` reads where JAX reads `jax.process_count()`; `dp > 1` in one process
    raises (JAX builds a mesh over that process's devices).
  - Only rank 0 writes checkpoints, TensorBoard events and metrics.json.
  - Host DAgger runs (the JAX `training/dagger.py:272` fault), and host eval sizes its
    step budget from the envs' own horizon (JAX's `training/evaluate.py:158` fixes
    it at 512).
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from embodied_clip_tpu_torch.config.experiments import _REGISTRY, Experiment
from embodied_clip_tpu_torch.constants import ROBOTHOR_OBJECT_TYPES

__all__ = ["NavRLExperiment", "_GoalMappedEnv"]

_ENCODER_BY_NAME = {
    "clipresnet50": "clip_rn50",
    "clipresnet50x16": "clip_rn50x16",
    "resnet50": "imagenet_rn50",
    "resnet18": "imagenet_rn18",
    "clip": "clip_rn50",
    "imagenet": "imagenet_rn50",
    "scratch": None,
}


@dataclasses.dataclass
class NavRLExperiment(Experiment):
    task: str = "objectnav"                  # objectnav | pointnav
    algo: str = "ddppo"                      # ddppo | dagger
    encoder: Optional[str] = "clip_rn50"     # None = scratch CNN trained end-to-end
    zeroshot: bool = False                   # CLIP text-embedding goals
    rgbd: bool = False                       # add a depth channel (habitat rgbd)
    dagger_aggregate: int = 8                # DAgger aggregate buffer, in rollouts
    backend: str = "fake"
    total_env_steps: int = 1_000_000
    rollout_len: int = 64
    env_batch: int = 32
    hidden: int = 512
    lr: float = 3e-4
    ppo_epochs: int = 4
    # PPO minibatched epochs + linear LR decay — the reference's habitat DD-PPO
    # training surface (baselines_habitat.md:63-75: 2 epochs × 2 minibatches,
    # use_linear_lr_decay). lr_decay_updates: 0 = constant LR; -1 = decay to 0
    # over this run's total update count; >0 = explicit update horizon.
    num_minibatches: int = 1
    lr_decay_updates: int = 0
    encoder_dtype: str = "bfloat16"
    ckpt_every_steps: int = 250_000
    eval_episodes: int = 200
    seed: int = 1
    log_dir: Optional[str] = None
    # Data-parallel replica count (the reference's NUM_GPUS knob,
    # baselines_habitat.md:63-69): one process per card in a torch.distributed
    # group, the env batch split over them, gradients all-reduced.
    dp: int = 1
    # Host-rollout double-buffering: split the worker pool into this many groups and
    # software-pipeline them — the device act step (frozen encode + policy) for one
    # group overlaps the other groups' simulator steps. 1 = sequential act→step. PPO
    # backends only (DAgger's synchronous expert queries can't pipeline).
    pipeline_groups: int = 1
    # "native" = this repo's ActorCritic; "allenact" = the released-checkpoint
    # architecture (models/allenact_policy.py) — use with `ckpt` pointing at a
    # converted checkpoint to eval the published RoboTHOR ObjectNav models
    # (baselines_robothor_objectnav.md:54-68).
    policy_arch: str = "native"
    # The card ("cuda") unless the caller asks for the CPU ("cpu").
    device: str = "cuda"

    def _lr_decay_updates(self, envs_per_iter: Optional[int] = None) -> int:
        """Resolve the lr_decay_updates convention: -1 = linear decay to zero over
        this run's OPTIMIZER-step count (habitat's use_linear_lr_decay semantics,
        baselines_habitat.md:63-75). The schedule advances once per optimizer update
        — ppo_epochs × num_minibatches times per train iteration — so the horizon
        counts those, not iterations; and the host backend's envs-per-iteration is the
        worker count, not env_batch."""
        if self.lr_decay_updates == -1:
            envs = envs_per_iter or self.env_batch
            iters = max(1, self.total_env_steps // (self.rollout_len * envs))
            # iter_minibatches emits min(m, B) non-empty minibatches — with
            # fewer envs than minibatches the horizon must match the actual
            # optimizer-step count or the LR never reaches zero.
            mb = max(1, min(self.num_minibatches, envs))
            return iters * max(1, self.ppo_epochs) * mb
        return self.lr_decay_updates

    def _check_dp(self) -> None:
        from embodied_clip_tpu_torch.parallel import mesh

        if self.dp > 1 and mesh.world_size() == 1:
            raise ValueError(
                f"dp={self.dp} runs one process per card in a torch.distributed group: "
                "start the processes with parallel.distributed.initialize_distributed "
                "(ECT_COORDINATOR, ECT_NUM_PROCESSES, ECT_PROCESS_ID) or "
                "parallel.dryrun.run_ranks; one process trains with dp=1")

    # --------------------------------------------------------------- construction

    def _build_fake_env(self):
        if self.task == "rearrange":
            from embodied_clip_tpu_torch.envs.rearrange import GridRearrangeEnv

            return GridRearrangeEnv(size=8, max_steps=96)
        if self.task == "rearrange2":
            from embodied_clip_tpu_torch.envs.rearrange import GridTwoPhaseRearrangeEnv

            return GridTwoPhaseRearrangeEnv(size=8, max_steps=96)
        from embodied_clip_tpu_torch.envs.gridworld import GridNavEnv

        class_set = None
        if self.zeroshot:
            from embodied_clip_tpu_torch.zeroshot import seen_unseen_class_ids

            class_set = seen_unseen_class_ids()[0]
        # The fake env always emits uint8 RGB frames: with a frozen encoder the
        # encoder runs INSIDE the rollout (the reference's ClipResNetPreprocessor
        # in the rollout, baselines_robothor_objectnav.md:48-51), and scratch
        # configs train their ScratchCNN on pixels (baselines_habitat.md:75). Either
        # way the policy architecture matches the host backends', so checkpoints
        # restore into thor/habitat-backend learners and eval. rgbd adds depth.
        return GridNavEnv(size=8, max_steps=64, class_set=class_set, task=self.task,
                          frame_obs=True, depth_obs=self.rgbd)

    def _goal_spec(self):
        if self.zeroshot:
            return "text_embed", 1024
        if self.task == "pointnav":
            return "pointgoal", 2
        if self.task == "rearrange":
            return "none", 1  # goal is implicit in the observation
        if self.task == "rearrange2":
            return "object_embed", 1024  # the phase flag rides the embedding
        return "object_embed", 1024

    def _make_policy(self, num_actions: int, frame_obs: bool, flat_obs: bool = False,
                     num_goal_classes=None, visual_shape: Optional[Tuple[int, ...]] = None,
                     depth: bool = False):
        """The ONE policy factory — fake-backend training, host-backend training and
        host eval all construct through here, so checkpoints restore across backends
        (identical state_dicts). `visual_shape` is the per-sample shape of the policy's
        visual input (the frozen encoder's feature, the frames, or the env's map);
        `depth` whether observations carry a depth channel. Weights are on the CPU."""
        from embodied_clip_tpu_torch.models.policy import ActorCritic

        if self.policy_arch == "allenact":
            # The released-checkpoint architecture. Same (obs, h, is_start) surface
            # as ActorCritic, so all act/eval paths drive it unchanged.
            from embodied_clip_tpu_torch.models.allenact_policy import (
                AllenActResnetPolicy,
            )

            if self.encoder is None or not self._encoder_emits_map() \
                    or self._goal_spec()[0] != "object_embed":
                raise ValueError(
                    "policy_arch=allenact needs a conv-map frozen encoder and "
                    "object-class goals (the released RoboTHOR ObjectNav "
                    "models, baselines_robothor_objectnav.md:58-64)")
            grid, _, channels = _require_shape(visual_shape)
            return AllenActResnetPolicy(
                in_channels=channels, grid=grid, num_actions=num_actions,
                num_goal_classes=(num_goal_classes if num_goal_classes
                                  is not None else len(ROBOTHOR_OBJECT_TYPES)),
                hidden=self.hidden)
        if self.policy_arch != "native":
            raise ValueError(f"unknown policy_arch {self.policy_arch!r} "
                             "(native | allenact)")
        if frame_obs and self.encoder is not None \
                and not self._encoder_emits_map():
            # Flat-embed encoders (CLIP ViT) ride the flat-visual policy path
            # (the encoder-sweep surface, imagenet_vs_objectnav.md:6-11).
            if self.rgbd:
                raise ValueError(
                    f"rgbd requires a conv-map encoder (depth pools to the "
                    f"conv-map grid) but '{self.encoder}' emits a flat embed "
                    "— use a resnet encoder or drop rgbd")
            flat_obs = True
        goal_kind, goal_dim = self._goal_spec()
        return ActorCritic(
            num_actions, _require_shape(visual_shape), goal_kind=goal_kind,
            num_goal_classes=(num_goal_classes if num_goal_classes is not None
                              else len(ROBOTHOR_OBJECT_TYPES)),
            goal_input_dim=goal_dim, hidden=self.hidden,
            visual_is_map=not flat_obs,
            scratch_cnn=self.encoder is None and frame_obs, depth=depth,
        )

    def _build_policy(self, env, encode=None):
        """The policy for the batched env `env` (its frames encoded by `encode`, built
        here when the env emits frames and the experiment has an encoder)."""
        frame_obs = getattr(env, "frame_obs", False)
        if encode is None and frame_obs:
            encode = self._encode_fn()
        if encode is not None and frame_obs:
            shape = encode.feature_shape
        else:
            inner = getattr(env, "inner", env)
            shape = tuple(inner.reset(torch.Generator().manual_seed(0), 1)[1]["visual"]
                          .shape[1:])
        return self._make_policy(
            env.num_actions, frame_obs, getattr(env, "flat_obs", False),
            getattr(env, "num_classes", None), visual_shape=shape,
            depth=getattr(env, "depth_obs", False))

    def _host_visual_shape(self, frame_shape, encode) -> Tuple[int, ...]:
        """The policy's visual input on a host backend: the encoder's feature (or the
        frames), with the goal view's channels beside the current view's for 1-phase
        THOR rearrangement (the collector concatenates them)."""
        views = 2 if self.backend == "thor" and self.task == "rearrange" else 1
        shape = encode.feature_shape if encode is not None else tuple(frame_shape)
        return tuple(shape[:-1]) + (shape[-1] * views,)

    def _calibration_frames(self) -> np.ndarray:
        """Representative uint8 NHWC frames for int8 PTQ activation calibration.

        Per-tensor max scales derived from synthetic noise mis-scale natural-image
        activations, so calibrate on the structured golden parity frames, topped up
        with 8 frames that the fake backend's env renders (from a CPU generator seeded
        0), tiled up to the golden frames' size.
        """
        from embodied_clip_tpu_torch.parity import golden_frames

        frames = [golden_frames(n=16)]
        if self.backend == "fake" and not self.task.startswith("rearrange") \
                and self.encoder is not None:
            env = self._build_fake_env()
            _, obs = env.reset(torch.Generator().manual_seed(0), 8)
            if "visual" in obs and obs["visual"].dtype == torch.uint8 \
                    and obs["visual"].ndim == 4:
                v = obs["visual"].numpy()
                h, w = frames[0].shape[1:3]
                reps = (max(1, -(-h // v.shape[1])), max(1, -(-w // v.shape[2])))
                v = np.tile(v, (1, reps[0], reps[1], 1))[:, :h, :w]
                frames.append(v)
        return np.concatenate(frames, axis=0)

    def _encoder_emits_map(self) -> bool:
        """Whether the frozen encoder emits a spatial conv map (vs a flat embed). CLIP
        ViTs emit only `clip_embed` (B, D); those route through the flat-visual policy
        path instead of the compressor CNN."""
        if self.encoder is None:
            return True
        from embodied_clip_tpu_torch.models.clip_vit import CLIP_VIT_CONFIGS
        from embodied_clip_tpu_torch.models.encoders import ENCODER_SPECS

        if self.encoder not in ENCODER_SPECS:
            raise ValueError(
                f"unknown encoder '{self.encoder}' — one of "
                f"{sorted(ENCODER_SPECS)}")
        return ENCODER_SPECS[self.encoder].arch not in CLIP_VIT_CONFIGS

    def _encode_fn(self):
        """uint8 frames → the frozen encoder's feature (the conv map, or `clip_embed`
        for ViTs), a `training.frames.FrameEncoder` on `device`; None when training
        from scratch (or for the rearrange fake env, whose observations are symbolic
        maps). Built once per experiment and setting."""
        if self.encoder is None:
            return None
        if self.backend == "fake" and self.task.startswith("rearrange"):
            return None
        setting = (self.encoder, self.encoder_dtype, self.backend, self.task, self.device)
        cache = self.__dict__.setdefault("_encoders", {})
        if setting not in cache:
            from embodied_clip_tpu_torch.training.frames import frozen_encode_fn

            self._encoder_emits_map()  # a ValueError for an unknown encoder
            dtype = (torch.bfloat16 if self.encoder_dtype in ("bfloat16", "int8")
                     else torch.float32)
            int8 = self.encoder_dtype == "int8"
            # int8: the trunk quantized with activation scales from representative
            # frames (`_calibration_frames`), never synthetic noise. The key is the
            # conv map's (`{prefix}_conv`), or `clip_embed` for a ViT.
            cache[setting], _ = frozen_encode_fn(
                self.encoder, dtype, int8=int8,
                calibration_frames=self._calibration_frames() if int8 else None,
                device=self.device)
        return cache[setting]

    def _goal_map_fn(self, env):
        """zero-shot: goal ids → rows of a frozen CLIP RN50 text-goal table (f32, on
        `device`); otherwise None. Random-but-frozen without pretrained weights — the
        wiring (and seen/unseen split) is the same."""
        if not self.zeroshot:
            return None
        from embodied_clip_tpu_torch.models.clip import build_clip
        from embodied_clip_tpu_torch.models.tokenizer import SimpleTokenizer
        from embodied_clip_tpu_torch.zeroshot import goal_map_fn, text_goal_table

        # Real RoboTHOR class names (zeroshot_objectnav.md:31-32 vocabulary) so the
        # frozen text-goal embeddings are meaningful once real CLIP weights load.
        n = getattr(env, "num_classes", 12)
        names = list(ROBOTHOR_OBJECT_TYPES[:n])
        names += [f"object {i}" for i in range(len(names), n)]
        cache = self.__dict__.setdefault("_goal_tables", {})
        setting = (tuple(names), self.device)
        if setting not in cache:
            clip = build_clip("RN50", device=self.device)
            cache[setting] = text_goal_table(clip, SimpleTokenizer(), names)
        return goal_map_fn(cache[setting])

    def _sync(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    # ----------------------------------------------------------------------- train

    def train(self, output_dir: str, ckpt: Optional[str] = None) -> dict:
        from embodied_clip_tpu_torch.parallel import mesh
        from embodied_clip_tpu_torch.training.dagger import DAggerConfig, DAggerLearner
        from embodied_clip_tpu_torch.training.ddppo import DDPPOConfig, DDPPOLearner
        from embodied_clip_tpu_torch.training.ppo import PPOConfig
        from embodied_clip_tpu_torch.utils.checkpoint import (
            StepCheckpointer,
            restore_params,
        )
        from embodied_clip_tpu_torch.utils.seeding import seed_everything

        if self.backend != "fake":
            return self._train_host(output_dir, ckpt)
        self._check_dp()

        generator = seed_everything(self.seed, self.device)
        # Each process draws its own envs' episodes and actions (JAX splits one key
        # over the sharded env batch); one process keeps `seed` itself.
        generator.manual_seed(self.seed + mesh.rank())
        env = self._build_fake_env()
        encode = self._encode_fn()
        policy = self._build_policy(env, encode)
        goal_map = self._goal_map_fn(env)

        if self.algo == "dagger":
            learner = DAggerLearner(env, policy, DAggerConfig(
                rollout_len=self.rollout_len, env_batch=self.env_batch, lr=self.lr,
                aggregate_size=self.dagger_aggregate),
                encode_fn=encode, device=self.device)
        else:
            learner = DDPPOLearner(env, policy, DDPPOConfig(
                rollout_len=self.rollout_len, env_batch=self.env_batch,
                num_minibatches=self.num_minibatches,
                ppo=PPOConfig(lr=self.lr, epochs=self.ppo_epochs,
                              lr_decay_updates=self._lr_decay_updates())),
                encode_fn=encode, device=self.device)
        # goal mapping for the fake env: the collect-time goal goes through a wrapper
        if goal_map is not None:
            env = _GoalMappedEnv(env, goal_map)
            learner.env = env

        act = learner.init(generator)
        ckpts = StepCheckpointer(os.path.join(output_dir, self.name), prefix="exp")
        steps_per_iter = self.rollout_len * self.env_batch
        env_steps, it = 0, 0

        def train_state():
            # Every process's act carry and generator, gathered (a collective).
            return {"params": policy.state_dict(), "opt_state": learner.tx.state_dict(),
                    "act": _gathered(_act_tree(act)),
                    "generator": _gathered(generator.get_state())}

        if ckpt:
            policy.load_state_dict(restore_params(ckpt, policy.state_dict()))
        else:
            # Resume-on-restart from the latest step-stamped checkpoint (DD-PPO
            # preemption tolerance; SURVEY.md §5). Full train state — params, opt
            # state (Adam moments + schedule position), the act carry (env state,
            # obs, hidden) and the generator — so a resumed run is bitwise identical
            # to an uninterrupted one (the reference's restorable …__steps_N.pt
            # contract, baselines_robothor_objectnav.md:58-64).
            latest, state = ckpts.restore_latest(train_state())
            if latest is not None:
                policy.load_state_dict(state["params"])
                learner.tx.load_state_dict(state["opt_state"])
                act = _act_from_tree(act, state["act"][mesh.rank()])
                generator.set_state(state["generator"][mesh.rank()])
                env_steps = latest
                it = env_steps // steps_per_iter

        writer = None
        if self.log_dir and mesh.rank() == 0:
            from embodied_clip_tpu_torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(os.path.join(self.log_dir, self.name))

        last_ckpt = env_steps
        metrics = {}

        def save_state(step):
            state = train_state()
            if mesh.rank() == 0:
                ckpts.save(step, state)

        # Wall-clock throughput is a logged trainer metric on the on-device path too:
        # windows of 10 iterations, the card synced at their ends, so the rate is
        # the device's, not the launch queue's.
        t_start = time.perf_counter()
        start_steps, start_it = env_steps, it
        win_t, win_steps, win_it = t_start, env_steps, it
        while env_steps < self.total_env_steps:
            if self.algo == "dagger":
                act, metrics = learner.train_iteration(act, it, generator)
            else:
                act, metrics = learner.train_iteration(act, generator)
            env_steps += steps_per_iter
            it += 1
            if it % 10 == 0:
                self._sync()
                now = time.perf_counter()
                metrics["env_steps_per_s"] = (
                    (env_steps - win_steps) / max(now - win_t, 1e-9))
                metrics["iteration_time_s"] = (
                    (now - win_t) / max(it - win_it, 1))
                win_t, win_steps, win_it = now, env_steps, it
            if writer and it % 10 == 0:
                for k in ("success", "spl", "loss", "entropy", "reward_per_step",
                          "env_steps_per_s", "iteration_time_s"):
                    if k in metrics:
                        writer.add_scalar(k, float(metrics[k]), env_steps)
            if env_steps - last_ckpt >= self.ckpt_every_steps:
                save_state(env_steps)
                last_ckpt = env_steps
        save_state(env_steps)
        self._sync()
        total_t = time.perf_counter() - t_start
        if "env_steps_per_s" not in metrics and it > start_it:
            # no 10-iteration window completed: this run's steps and iterations over
            # its time (NOT the last partial window's steps over total time, which
            # understates the rate; nor a resumed run's earlier iterations)
            metrics["env_steps_per_s"] = (
                (env_steps - start_steps) / max(total_t, 1e-9))
            metrics["iteration_time_s"] = total_t / (it - start_it)
        if writer:
            writer.close()
        out = {k: float(v) for k, v in metrics.items()}
        out["env_steps"] = env_steps
        self._last_params = policy.state_dict()
        self._last_policy = policy
        self._last_env = env
        self._last_learner = learner
        return out

    # host backends -------------------------------------------------------------

    num_workers: int = 8
    straggler_cutoff: float = 1.0   # <1.0 enables DD-PPO laggard masking
    # Inject a Controller-compatible factory into the THOR adapters (tests pass the
    # scripted fixture; None = the real ai2thor.Controller). Workers unpickle it, so
    # it is a class or a module-level function.
    controller_factory: Optional[object] = None
    # Override the simulator episode horizon (None = each adapter's default).
    max_episode_steps: Optional[int] = None

    def _host_env_fns(self, eval_split: bool = False, seed_offset: int = 0):
        """Per-worker env factories (`functools.partial`s: the pool's workers unpickle
        them) and the frame shape. seed_offset shifts worker seeds to GLOBAL env
        indices in multi-process DD-PPO (process p's workers are global envs
        p*num_workers..(p+1)*num_workers-1), so an N-process run steps exactly the envs
        a single-process run of N*num_workers would."""
        ms = {} if self.max_episode_steps is None \
            else {"max_steps": self.max_episode_steps}
        seeds = range(seed_offset, seed_offset + self.num_workers)
        if self.backend == "hostgrid":
            from embodied_clip_tpu_torch.envs.host_gridworld import HostGridNav

            return [functools.partial(HostGridNav, size=6, seed=s, **ms)
                    for s in seeds], (56, 56, 3)
        if self.backend == "thor":
            cf = self.controller_factory
            if self.task in ("rearrange", "rearrange2"):
                from embodied_clip_tpu_torch.envs.thor_rearrange import (
                    THORRearrangeEnv,
                    THORTwoPhaseRearrangeEnv,
                )

                cls = (THORTwoPhaseRearrangeEnv if self.task == "rearrange2"
                       else THORRearrangeEnv)
                scenes = [f"FloorPlan{i}" for i in range(1, 21)]
                return [functools.partial(cls, scenes, seed=s, controller_factory=cf,
                                          **ms) for s in seeds], (300, 300, 3)
            from embodied_clip_tpu_torch.envs.thor import THORObjectNavEnv

            # RoboTHOR scene split: train scenes for rollouts, val scenes for
            # checkpoint eval (the reference's eval contract,
            # baselines_robothor_objectnav.md:54-68).
            if eval_split:
                scenes = [f"FloorPlan_Val{i}_{j}"
                          for i in range(1, 4) for j in range(1, 6)]
            else:
                scenes = [f"FloorPlan_Train{i}_{j}"
                          for i in range(1, 13) for j in range(1, 6)]
            return [functools.partial(THORObjectNavEnv, scenes, seed=s,
                                      controller_factory=cf, **ms)
                    for s in seeds], (300, 300, 3)
        if self.backend == "habitat":
            from embodied_clip_tpu_torch.envs.habitat import HabitatNavEnv

            cfg = os.environ.get("ECT_HABITAT_CONFIG", f"configs/tasks/{self.task}.yaml")
            # checkpoint eval runs on the yaml's val split (--run-type eval,
            # baselines_habitat.md:88-97); training uses the configured split.
            split = "val" if eval_split else None
            return [functools.partial(HabitatNavEnv, cfg, task=self.task, seed=s,
                                      rgb_only=not self.rgbd, split=split, **ms)
                    for s in seeds], (480, 640, 3)
        raise ValueError(f"unknown backend {self.backend!r}")

    def _host_policy(self, frame_shape, encode):
        if self.task.startswith("rearrange"):
            from embodied_clip_tpu_torch.envs.thor_rearrange import REARRANGE_ACTIONS

            num_actions = len(REARRANGE_ACTIONS)
        else:
            num_actions = 6  # the unified THOR ObjectNav/PointNav space
        policy = self._make_policy(
            num_actions, frame_obs=True,
            visual_shape=self._host_visual_shape(frame_shape, encode),
            depth=self.rgbd and self.backend == "habitat")
        return policy, num_actions

    def _train_host(self, output_dir: str, ckpt: Optional[str]) -> dict:
        """THOR/Habitat (and hostgrid) backends: VectorEnv pool + host rollouts + the
        PPO (or DAgger) update on the card."""
        from embodied_clip_tpu_torch.envs.vector import VectorEnv
        from embodied_clip_tpu_torch.parallel import mesh
        from embodied_clip_tpu_torch.parallel.distributed import initialize_distributed
        from embodied_clip_tpu_torch.training.ddppo import DDPPOConfig
        from embodied_clip_tpu_torch.training.host_ppo import HostPPOLearner
        from embodied_clip_tpu_torch.training.ppo import PPOConfig
        from embodied_clip_tpu_torch.utils.checkpoint import (
            StepCheckpointer,
            restore_params,
        )
        from embodied_clip_tpu_torch.utils.seeding import seed_everything

        # Multi-process bring-up from the ECT_* variables (a no-op in one process,
        # idempotent when the caller already joined a group): the reference's
        # N-learner-processes deployment (baselines_habitat.md:63-69), each process
        # owning a VectorEnv pool of num_workers simulators.
        initialize_distributed(device=self.device)
        self._check_dp()
        world, pid = mesh.world_size(), mesh.rank()
        if world > 1 and self.algo == "dagger":
            raise NotImplementedError(
                "multi-process DAgger is not supported (synchronous expert "
                "queries don't shard); run DAgger single-process")

        seed_everything(self.seed, self.device)
        env_fns, frame_shape = self._host_env_fns(seed_offset=pid * self.num_workers)
        horizon = _horizon(env_fns[0])
        # DAgger has no straggler-cutoff semantics (expert queries are synchronous).
        cutoff = 1.0 if self.algo == "dagger" else self.straggler_cutoff
        groups = self.pipeline_groups if self.algo != "dagger" else 1
        groups = max(1, min(groups, len(env_fns)))
        bounds = [len(env_fns) * g // groups for g in range(groups + 1)]
        pools = [VectorEnv(env_fns[bounds[g]:bounds[g + 1]], frame_shape=frame_shape,
                           cutoff_fraction=cutoff, max_steps=horizon)
                 for g in range(groups)]
        venv = pools[0]
        try:
            encode = self._encode_fn()
            policy, _ = self._host_policy(frame_shape, encode)
            if self.algo == "dagger":
                from embodied_clip_tpu_torch.training.dagger import (
                    DAggerConfig,
                    HostDAggerLearner,
                )

                learner = HostDAggerLearner(venv, policy, DAggerConfig(
                    rollout_len=self.rollout_len, env_batch=venv.n, lr=self.lr,
                    epochs=self.ppo_epochs, aggregate_size=self.dagger_aggregate),
                    encode_fn=encode, goal_map_fn=self._goal_map_fn(venv),
                    device=self.device)
            else:
                global_envs = len(env_fns) * world
                learner = HostPPOLearner(
                    pools if groups > 1 else venv, policy, DDPPOConfig(
                        rollout_len=self.rollout_len, env_batch=global_envs,
                        num_minibatches=self.num_minibatches,
                        ppo=PPOConfig(lr=self.lr, epochs=self.ppo_epochs,
                                      lr_decay_updates=self._lr_decay_updates(
                                          envs_per_iter=global_envs))),
                    encode_fn=encode, goal_map_fn=self._goal_map_fn(venv),
                    env_id_offset=pid * len(env_fns), device=self.device)
            learner.init(self.seed)
            ckpts = StepCheckpointer(os.path.join(output_dir, self.name), prefix="exp")

            def train_state():
                return {"params": policy.state_dict(),
                        "opt_state": learner.tx.state_dict()}

            env_steps = 0
            if ckpt:
                policy.load_state_dict(restore_params(ckpt, policy.state_dict()))
            else:
                # Full train state; the simulators' state lives in the worker
                # processes and cannot be checkpointed, so envs restart fresh on
                # resume — as in the reference (its .pt files hold no simulator
                # state).
                latest, state = ckpts.restore_latest(train_state())
                if latest is not None:
                    policy.load_state_dict(state["params"])
                    learner.tx.load_state_dict(state["opt_state"])
                    env_steps = latest
            steps_per_iter = self.rollout_len * len(env_fns) * world
            last_ckpt = env_steps
            metrics = {}
            writer = None
            if self.log_dir and pid == 0:
                from embodied_clip_tpu_torch.utils.tensorboard import SummaryWriter

                writer = SummaryWriter(os.path.join(self.log_dir, self.name))

            def save_state(step):
                if pid == 0:
                    ckpts.save(step, train_state())

            while env_steps < self.total_env_steps:
                if self.algo == "dagger":
                    metrics = learner.train_iteration(env_steps // steps_per_iter)
                else:
                    metrics = learner.train_iteration()
                env_steps += steps_per_iter
                if writer:
                    # throughput + per-stage timing are first-class trainer metrics
                    for k in ("success", "spl", "loss", "env_steps_per_s",
                              "act_frac", "env_step_frac", "update_frac"):
                        if k in metrics:
                            writer.add_scalar(k, float(metrics[k]), env_steps)
                if env_steps - last_ckpt >= self.ckpt_every_steps:
                    save_state(env_steps)
                    last_ckpt = env_steps
            save_state(env_steps)
            if writer:
                writer.close()
            self._last_params = policy.state_dict()
            self._last_policy = policy
            self._last_learner = learner
            out = {k: float(v) for k, v in metrics.items()}
            out["env_steps"] = env_steps
            return out
        finally:
            for pool in pools:
                pool.close()

    # ------------------------------------------------------------------------ eval

    def evaluate(self, output_dir: str, ckpt: Optional[str] = None) -> dict:
        """Checkpoint evaluation. backend=fake evaluates on the batched gridworld;
        backend=thor/habitat/hostgrid evaluates ON THE SIMULATOR (val scenes for
        RoboTHOR) via evaluate_policy_host — the reference's eval contract
        (baselines_robothor_objectnav.md:54-68, baselines_habitat.md:88-97). Both paths
        write the same metrics.json schema (rank 0 writes it)."""
        from embodied_clip_tpu_torch.parallel import mesh
        from embodied_clip_tpu_torch.training.evaluate import (
            compute_scores,
            evaluate_policy,
            write_metrics_json,
        )
        from embodied_clip_tpu_torch.utils.checkpoint import restore_params

        if self.backend != "fake":
            episodes = self._evaluate_host(ckpt)
        else:
            env = getattr(self, "_last_env", None) or self._build_fake_env()
            encode = self._encode_fn()
            if ckpt:
                policy = self._build_policy(env, encode).to(self.device)
                policy.load_state_dict(restore_params(ckpt, policy.state_dict()))
            else:
                policy = getattr(self, "_last_policy", None)
                if policy is None:
                    raise ValueError("evaluate needs --ckpt or a preceding train()")

            if self.zeroshot:
                # Evaluate on the full vocabulary (seen + unseen), reference
                # zeroshot_objectnav.md:22: eval runs with the original 12 object
                # types.
                env = dataclasses.replace(getattr(env, "inner", env), class_set=None)

            # Real vocabulary in the eval records (the reference's per-object-type
            # aggregation schema, zeroshot_objectnav.md:34-47, keys on class names).
            n_classes = getattr(env, "num_classes", 12)
            names = list(ROBOTHOR_OBJECT_TYPES[:n_classes])
            names += [f"Class{i}" for i in range(len(names), n_classes)]
            episodes = evaluate_policy(
                env, policy, torch.Generator(device=self.device).manual_seed(self.seed),
                num_episodes=self.eval_episodes, class_names=names,
                goal_map_fn=self._goal_map_fn(env), encode_fn=encode)
        # Multi-process eval: episodes are already the MERGED records (see
        # _evaluate_host); exactly one process writes the single metrics.json.
        path = os.path.join(output_dir, self.name, "metrics.json")
        if mesh.rank() == 0:
            os.makedirs(os.path.join(output_dir, self.name), exist_ok=True)
            path = write_metrics_json(path, episodes)
            per_type = {
                t: compute_scores(path, t)
                for t in sorted({e["task_info"]["object_type"] for e in episodes})
            }
        else:
            # same aggregation as compute_scores, from the in-memory records (rank
            # 0's file may not be on this host's filesystem)
            path = None
            per_type = {}
            for t in sorted({e["task_info"]["object_type"] for e in episodes}):
                eps = [e for e in episodes if e["task_info"]["object_type"] == t]
                per_type[t] = (sum(e["success"] for e in eps) / len(eps),
                               sum(e["spl"] for e in eps) / len(eps))
        overall = {
            "success": float(np.mean([e["success"] for e in episodes])),
            "spl": float(np.mean([e["spl"] for e in episodes])),
            "episodes": len(episodes),
            "episodes_requested": self.eval_episodes,
            "metrics_file": path,
        }
        if mesh.world_size() > 1:
            overall["episodes_local"] = int(getattr(self, "_eval_episodes_local", 0))
        overall["per_object_type"] = {t: {"success": s, "spl": p}
                                      for t, (s, p) in per_type.items()}
        return overall

    def _evaluate_host(self, ckpt: Optional[str]):
        """Eval on the simulator pool (VectorEnv of THOR/Habitat/hostgrid workers),
        RoboTHOR val scenes. Returns per-episode records.

        Multi-process runs (the same launcher as training, baselines_habitat.md:88-97)
        SHARD the episode request: process p owns its own pool (worker seeds offset to
        global env indices, like training), evaluates its share of eval_episodes, and
        the records are all-gathered so every process returns the merged list — no
        duplicated pools, no duplicated episodes, one metrics.json (written by rank 0
        in evaluate())."""
        from embodied_clip_tpu_torch.envs.vector import VectorEnv
        from embodied_clip_tpu_torch.parallel import mesh
        from embodied_clip_tpu_torch.parallel.distributed import initialize_distributed
        from embodied_clip_tpu_torch.training.evaluate import evaluate_policy_host
        from embodied_clip_tpu_torch.utils.checkpoint import restore_params, restore_pytree

        initialize_distributed(device=self.device)
        world, pid = mesh.world_size(), mesh.rank()
        local_episodes = (self.eval_episodes // world
                          + (1 if pid < self.eval_episodes % world else 0))
        if local_episodes == 0:
            # More processes than episodes: skip the simulator pool entirely — only
            # the merge collective must still run on every process.
            self._eval_episodes_local = 0
            return _gather_records([])
        env_fns, frame_shape = self._host_env_fns(
            eval_split=True, seed_offset=pid * self.num_workers)
        venv = VectorEnv(env_fns, frame_shape=frame_shape, max_steps=_horizon(env_fns[0]))
        try:
            encode = self._encode_fn()
            policy, num_actions = self._host_policy(frame_shape, encode)
            if self.policy_arch == "allenact" and ckpt:
                # converted checkpoints carry the released model's exact dims
                # (compressor/combiner widths, hidden); rebuild the module from them
                # — the native defaults only cover the standard released configs.
                from embodied_clip_tpu_torch.models.allenact_policy import (
                    AllenActResnetPolicy,
                )

                raw = restore_pytree(ckpt)
                if isinstance(raw, dict) and "allenact_config" in raw:
                    cfg = {
                        k: (tuple(int(x) for x in np.asarray(v).reshape(-1))
                            if k in ("compressor_dims", "combiner_dims")
                            else int(np.asarray(v)))
                        for k, v in raw["allenact_config"].items()
                    }
                    policy = AllenActResnetPolicy(**cfg)
            last = getattr(self, "_last_policy", None)
            if ckpt:
                policy.load_state_dict(restore_params(ckpt, policy.state_dict()))
            elif last is not None:
                policy.load_state_dict(last.state_dict())
            else:
                raise ValueError("evaluate needs --ckpt or a preceding train()")
            policy = policy.to(self.device)
            goal_map = self._goal_map_fn(venv) if self.zeroshot else None
            local = evaluate_policy_host(
                venv, policy, num_episodes=local_episodes, num_actions=num_actions,
                encode_fn=encode, goal_map_fn=goal_map,
                class_names=list(ROBOTHOR_OBJECT_TYPES), seed=self.seed,
                device=self.device)
            self._eval_episodes_local = len(local)
            return _gather_records(local)
        finally:
            venv.close()


def _require_shape(visual_shape) -> Tuple[int, ...]:
    if visual_shape is None:
        raise ValueError("the policy needs visual_shape, the per-sample shape of its "
                         "visual input (torch modules are built at their input width)")
    return tuple(visual_shape)


def _horizon(env_fn) -> int:
    """The episode horizon of the envs `env_fn` (a functools.partial) builds: its
    max_steps argument, or the env class's default."""
    if "max_steps" in env_fn.keywords:
        return env_fn.keywords["max_steps"]
    return inspect.signature(env_fn.func).parameters["max_steps"].default


def _act_tree(act):
    """An ActState as a tree of tensors: the env state's dataclass by its fields."""
    return {"env_state": {f.name: getattr(act.env_state, f.name)
                          for f in dataclasses.fields(act.env_state)},
            "obs": dict(act.obs), "h": act.h, "prev_action": act.prev_action,
            "is_start": act.is_start}


def _act_from_tree(like, tree):
    """`_act_tree`'s inverse, each tensor on the device of `like`'s."""
    def on(t, ref):
        return t.to(ref.device)

    state = like.env_state
    env_state = type(state)(**{k: on(v, getattr(state, k))
                               for k, v in tree["env_state"].items()})
    return type(like)(env_state=env_state,
                      obs={k: on(v, like.obs[k]) for k, v in tree["obs"].items()},
                      h=on(tree["h"], like.h),
                      prev_action=on(tree["prev_action"], like.prev_action),
                      is_start=on(tree["is_start"], like.is_start))


def _gathered(tree) -> list:
    """[every process's `tree`, its tensors copied to the CPU] in rank order (a
    collective in a process group; [tree] alone)."""
    import torch.distributed as dist

    from embodied_clip_tpu_torch.parallel import mesh
    from embodied_clip_tpu_torch.utils.checkpoint import _host_copy

    local = _host_copy(tree)
    if mesh.world_size() == 1:
        return [local]
    out = [None] * mesh.world_size()
    dist.all_gather_object(out, local)
    return out


def _gather_records(records: list) -> list:
    """Every process's records, concatenated in rank order (the torch.distributed
    gather of the reference's multi-GPU eval launcher)."""
    return [r for part in _gathered(list(records)) for r in part]


class _GoalMappedEnv:
    """Wrap a batched on-device env (`reset(generator, batch)`, `step(state, action,
    generator)`) so integer goals come out as embedding vectors."""

    def __init__(self, inner, goal_map):
        self.inner = inner
        self.goal_map = goal_map

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def reset(self, generator, batch: int):
        state, obs = self.inner.reset(generator, batch)
        return state, {**obs, "goal": self.goal_map(obs["goal"])}

    def step(self, state, action, generator):
        state, obs, r, d, info = self.inner.step(state, action, generator)
        return state, {**obs, "goal": self.goal_map(obs["goal"])}, r, d, info


def _reg(name, **kw):
    def factory(n=name, kw=kw):
        return NavRLExperiment(name=n, **kw)

    _REGISTRY[name] = factory


# RoboTHOR ObjectNav DD-PPO grid (backend 'thor' when available; 'fake' is hermetic).
for enc_tag in ("clipresnet50", "resnet50", "resnet18", "clipresnet50x16"):
    _reg(f"objectnav_robothor_rgb_{enc_tag}gru_ddppo",
         task="objectnav", encoder=_ENCODER_BY_NAME[enc_tag])

# Zero-shot ObjectNav (train on seen classes; eval config spans all 12).
_reg("zeroshot_objectnav_robothor_rgb_clipresnet50gru_ddppo",
     task="objectnav", encoder="clip_rn50", zeroshot=True)
_reg("zeroshot_objectnav_robothor_rgb_clipresnet50gru_ddppo_eval",
     task="objectnav", encoder="clip_rn50", zeroshot=True)

# Habitat grid — with the reference's habitat DD-PPO training surface
# (baselines_habitat.md:63-75): 2 PPO epochs × 2 minibatches, linear LR decay
# over the run.
_HABITAT_PPO = dict(ppo_epochs=2, num_minibatches=2, lr_decay_updates=-1)
for task in ("objectnav", "pointnav"):
    for enc_tag in ("clip", "imagenet"):
        _reg(f"ddppo_{task}_rgb_{enc_tag}",
             task=task, encoder=_ENCODER_BY_NAME[enc_tag], **_HABITAT_PPO)
_reg("ddppo_objectnav_rgb", task="objectnav", encoder=None, **_HABITAT_PPO)
_reg("ddppo_objectnav_rgbd", task="objectnav", encoder=None, rgbd=True,
     **_HABITAT_PPO)  # scratch + depth
# rgbd × frozen encoder ("replace rgb with rgbd in the exp-config",
# baselines_habitat.md:75): depth is pooled to the conv-map grid and fed to the
# trainable compressor alongside the frozen features (models/policy.py).
_reg("ddppo_objectnav_rgbd_clip", task="objectnav", encoder="clip_rn50",
     rgbd=True, **_HABITAT_PPO)
_reg("ddppo_objectnav_rgbd_imagenet", task="objectnav", encoder="imagenet_rn50",
     rgbd=True, **_HABITAT_PPO)

# iTHOR Rearrangement 1-phase DAgger (fake backend: pick→carry→place env).
_reg("one_phase_rgb_clipresnet50_dagger", task="rearrange", algo="dagger",
     encoder="clip_rn50")
_reg("one_phase_rgb_resnet50_dagger", task="rearrange", algo="dagger",
     encoder="imagenet_rn50")
# iTHOR Rearrangement 2-phase (walkthrough→unshuffle from memory) — the
# rearrangement branch's other documented task configuration
# (baselines_ithor_rearrangement.md:4-6; the released models are 1-phase only).
_reg("two_phase_rgb_clipresnet50_dagger", task="rearrange2", algo="dagger",
     encoder="clip_rn50")
_reg("two_phase_rgb_resnet50_dagger", task="rearrange2", algo="dagger",
     encoder="imagenet_rn50")
