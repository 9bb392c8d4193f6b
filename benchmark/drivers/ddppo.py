"""DD-PPO training on the device: `DDPPOLearner.train_iteration` (a T-step rollout of
the batched GridNav env with the frozen encoder inside it, then K PPO epochs).

Set-up builds one learner from the seed (the encoder's and the policy's weights made
by the benchmark and loaded into the program) and drives it through its first
`follow` iterations with the window's own call, recording each iteration's rollout,
each PPO step's loss, the optimiser's first moment after its first step (the first
clipped gradient times 1 - b1) and the parameters after the last. The same learner
then runs the window, whose unit is one iteration; the encoder's input frames and
output features at `sample_steps_per_unit` seeded steps of each window iteration are
kept (the last `keep_samples`).

Judged after the window: the kept features against the float32 reference encoder on
the same frames (`cos.<feature key>`), and the followed iterations against the plain
reference's replay of the same rollouts from the same weights (`reference/
actor_critic_ppo.py`): the relative gap of the first PPO step's loss (`loss_gap`), the
widest gap of a leaf's first-gradient norm (`grad_gap`), and the median leaf's gap of
its parameters' change over the followed iterations (`update_gap`), leaves whose
reference gradient is under a thousandth of the median leaf's left out. The later
steps' losses and the widest leaf's change are printed, not compared: Adam steps
each element by about the learning rate whatever its gradient's size, so an element
whose gradient sits at rounding level moves either way, and those numbers carry that
noise from seed to seed (PERF.md gives their readings). The reference follows the
program's rollouts, which depend on the program's own state: the encoder that produced
their features is judged on its own by `cos.*`. In a control run the reference itself,
in bfloat16 products, stands in for the program's training step.

On more than one card (`harness/ranks.py`) every rank runs this driver on its own card
and its own slice of the global env batch, with env streams of the seed of its own, and
the program sums the gradients over the ranks. After the window rank 0 takes the worst
`cos.*` over all ranks' kept features, sums the ranks' shares of each PPO step's loss,
and replays the followed iterations on the ranks' rollouts joined into one batch of all
the envs (the program's update is the one-process update on that union); and
`rank_param_gap`, the largest absolute difference of any rank's parameters from rank
0's after the followed iterations and after the window, is 0 when the replicas agree.
"""

from __future__ import annotations

import collections
import statistics

import torch

from benchmark.drivers.encode import max_distances
from benchmark.harness import ranks
from benchmark.harness.inputs import CALIBRATION, ENV, POLICY, SAMPLES, reference_module, tf32_off
from benchmark.harness.program import build_encoder, program_section
from benchmark.harness.runner import log
from benchmark.harness.weights import fill_, seeded_generator
from benchmark.reference import actor_critic_ppo as ac

KIND = "training"
B1 = 0.9   # Adam's first-moment decay, which the first moment is divided back by
RANK_STREAMS = 16   # rank r draws its envs from the seed's stream ENV + 16 r
ENV_AXIS_0 = ("h0", "last_value")   # rollout entries batched on axis 0, the rest on 1


class _Sampler:
    """The rollout's encode function, keeping (frames, features) of chosen steps."""

    def __init__(self, fn, period: int, picks, keep: int):
        self.fn, self.period, self.picks = fn, period, set(picks)
        self.calls, self.on, self.kept = 0, False, collections.deque(maxlen=keep)

    def __call__(self, frames):
        out = self.fn(frames)
        if self.on and self.calls % self.period in self.picks:
            self.kept.append((frames.clone(), out))
        self.calls += 1
        return out


def _gaps(prog: dict, ref: dict, leaves) -> dict:
    """Per leaf, the gap between the two sides' norms over the larger of the reference
    leaf's norm and the median leaf's."""
    norms = {k: float(ref[k].float().norm()) for k in leaves}
    floor = statistics.median(norms.values())
    return {k: abs(float(prog[k].float().norm()) - norms[k]) / max(norms[k], floor)
            for k in leaves}


class Driver:
    def __init__(self, cell, seed: int, device, control: bool = False, group=None):
        self.cell, self.seed, self.device, self.control = cell, seed, torch.device(device), control
        self.group = group or ranks.Solo()   # this rank's place among the run's ranks
        self.t = cell.traffic
        self.min_units = 1

    def setup(self):
        from embodied_clip_tpu_torch.envs.gridworld import GridNavEnv
        from embodied_clip_tpu_torch.models.policy import ActorCritic
        from embodied_clip_tpu_torch.training.ddppo import DDPPOConfig, DDPPOLearner
        from embodied_clip_tpu_torch.training.frames import FrameEncoder
        from embodied_clip_tpu_torch.training.ppo import PPOConfig

        cfg, t, dev, seed = self.cell.config, self.t, self.device, self.seed
        # The policy and its update in the precision the traffic states (PyTorch's
        # default runs float32 cuDNN convs in TF32).
        self.flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = t["tf32"]
        env = GridNavEnv(**t["env"])
        self.ref = reference_module(cfg, seed, dev)
        # Representative frames, as `quantize` asks: the env's own observations.
        calib = env.reset(seeded_generator(seed, CALIBRATION, dev),
                          cfg["calibration_frames"])[1]["visual"]
        enc = build_encoder(program_section(cfg, self.control), self.ref.state_dict(),
                            calib, dev)
        key = t["feature_key"]
        shape = tuple(enc.encode(calib[:1])[key].shape[1:])
        picks = torch.randint(0, t["rollout_len"] + 1, (t["sample_steps_per_unit"],),
                              generator=seeded_generator(seed, SAMPLES, "cpu")).tolist()
        self.sampler = _Sampler(FrameEncoder(enc, key, shape), t["rollout_len"] + 1, picks,
                                t["keep_samples"])
        with torch.device("meta"):
            ref_policy = ac.build(shape, env.num_actions, env.num_classes, t["hidden"])
        ref_policy = fill_(ref_policy.to_empty(device=dev), seeded_generator(seed, POLICY, dev))
        self.theta0 = {k: v.detach().clone() for k, v in ref_policy.state_dict().items()}
        policy = ActorCritic(env.num_actions, shape, goal_kind="object_embed",
                             num_goal_classes=env.num_classes, hidden=t["hidden"],
                             visual_is_map=True)
        policy.load_state_dict(self.theta0)
        self.ppo = dict(t["ppo"])
        learner = DDPPOLearner(env, policy, DDPPOConfig(
            rollout_len=t["rollout_len"], env_batch=t["env_batch"],
            ppo=PPOConfig(**self.ppo)), encode_fn=self.sampler, device=dev)
        self.gen = seeded_generator(seed, ENV + RANK_STREAMS * self.group.rank, dev)
        self.act = learner.init(self.gen)
        self.learner = learner
        self._follow(policy)
        if self.group.size > 1:
            self.param_gaps = [self._rank_param_gap()]

    def _follow(self, policy):
        """The first iterations, through the window's own call, with their rollouts,
        every PPO epoch's loss, the first moment after the first step and the final
        parameters recorded."""
        import embodied_clip_tpu_torch.training.ddppo as program_ddppo

        learner, tx = self.learner, self.learner.tx
        rollouts, first_mu, losses = [], [], []
        collect, step, loss_fn = learner.collect, tx.step, program_ddppo.ppo_loss

        def recording_collect(act, gen):
            out = collect(act, gen)
            rollouts.append(out[:2])
            return out

        def recording_step(grads=None):
            step(grads)
            if not first_mu:
                first_mu.append([m.detach().clone() for m in tx.mu])

        def recording_loss(*args, **kwargs):
            loss, metrics = loss_fn(*args, **kwargs)
            losses.append(float(loss.detach()))
            return loss, metrics

        learner.collect, tx.step = recording_collect, recording_step
        program_ddppo.ppo_loss = recording_loss
        try:
            for _ in range(self.t["follow"]):
                self.act, m = learner.train_iteration(self.act, self.gen)
        finally:
            del learner.collect, tx.step
            program_ddppo.ppo_loss = loss_fn
        self.losses = losses
        names = [n for n, _ in policy.named_parameters()]
        self.first_grad = {n: mu / (1 - B1) for n, mu in zip(names, first_mu[0])}
        self.followed = {n: p.detach().clone() for n, p in policy.named_parameters()}
        self.rollouts = [dict(visual=r.obs["visual"], goal=r.obs["goal"],
                              prev_action=r.obs["prev_action"], is_start=r.is_start,
                              actions=r.actions, log_probs=r.log_probs, values=r.values,
                              rewards=r.rewards, dones=r.dones, h0=r.h0, last_value=lv)
                         for r, lv in rollouts]

    def _rank_param_gap(self) -> float:
        """The largest absolute difference of this rank's parameters from rank 0's."""
        import torch.distributed as dist

        flat = torch.cat([p.detach().reshape(-1) for p in self.learner.policy.parameters()])
        first = flat.clone()
        dist.broadcast(first, 0)
        return float((flat - first).abs().max())

    def _joined_rollouts(self):
        """On rank 0, the followed rollouts of every rank joined, in rank order, into one
        batch of all the envs; the other ranks send theirs and get None."""
        import torch.distributed as dist

        rank, size = self.group.rank, self.group.size
        joined = []
        for ro in self.rollouts:
            out = {}
            for k, t in ro.items():
                t = t.contiguous()
                parts = [torch.empty_like(t) for _ in range(size)] if rank == 0 else None
                dist.gather(t, parts, dst=0)
                if rank == 0:
                    out[k] = torch.cat(parts, 0 if k in ENV_AXIS_0 else 1)
            joined.append(out)
        return None if rank else joined

    def start_window(self):
        self.sampler.on = True

    def unit(self, i: int):
        self.act, _ = self.learner.train_iteration(self.act, self.gen)

    def window_metrics(self, units: int, elapsed: float, unit_times) -> dict:
        return {"env_steps_per_s": units * self.t["rollout_len"] * self.t["env_batch"] / elapsed}

    def unit_work(self) -> dict:
        return {}

    def release(self):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.flags
        self.samples = list(self.sampler.kept)
        if self.group.size > 1:
            self.param_gaps.append(self._rank_param_gap())
        del self.learner, self.sampler, self.act
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self) -> dict:
        key = self.t["feature_key"]
        readings = {}
        if self.samples:
            frames = torch.cat([f for f, _ in self.samples])
            outs = {key: torch.cat([o for _, o in self.samples])}
            readings = max_distances(self.ref, self.cell.config, frames, outs, keys=[key])
        if self.group.size > 1:
            every = self.group.gather({"readings": readings, "losses": self.losses,
                                       "gap": max(self.param_gaps)})
            self.rollouts = self._joined_rollouts()
            if self.group.rank or not all(r["readings"] for r in every):
                return {}
            readings = {k: max(r["readings"][k] for r in every) for k in readings}
            self.losses = [sum(step) for step in zip(*(r["losses"] for r in every))]
            readings["rank_param_gap"] = max(r["gap"] for r in every)
        elif not self.samples:
            return {}
        hsz = self.t["hidden"]
        mask = torch.ones(3 * hsz, device=self.device)
        mask[:2 * hsz] = 0   # the recurrent r and z biases: not parameters of the cell
        with tf32_off():
            ref = ac.follow(self.theta0, self.rollouts, self.ppo,
                            grad_mask={"gru.bias_hh": mask})
            if self.control:
                prog = ac.follow(self.theta0, self.rollouts, self.ppo, torch.bfloat16,
                                 grad_mask={"gru.bias_hh": mask})
            else:
                prog = {"losses": self.losses, "first_grad": self.first_grad,
                        "params": self.followed}
        log(f"[ddppo] losses {prog['losses']!r}, reference {ref['losses']!r}")
        gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
        readings["loss_gap"] = gaps[0] if len(prog["losses"]) == len(ref["losses"]) else \
            float("inf")
        leaves = list(self.theta0)
        grad = _gaps(prog["first_grad"], ref["first_grad"], leaves)
        readings["grad_gap"] = max(grad.values())
        g = {k: float(ref["first_grad"][k].norm()) for k in leaves}
        floor = 1e-3 * statistics.median(g.values())
        moving = [k for k in leaves if g[k] >= floor]
        change = _gaps({k: prog["params"][k] - self.theta0[k] for k in moving},
                       {k: ref["params"][k] - self.theta0[k] for k in moving}, moving)
        readings["update_gap"] = statistics.median(change.values())
        wg, wc = max(grad, key=grad.get), max(change, key=change.get)
        log(f"[ddppo] not compared: every later PPO step's loss gap {gaps[1:]!r}; the widest "
            f"leaf's change gap {change[wc]!r} ({wc}); first gradient widest at {wg}; "
            f"leaves left out of the change: {sorted(set(leaves) - set(moving))}")
        return readings
