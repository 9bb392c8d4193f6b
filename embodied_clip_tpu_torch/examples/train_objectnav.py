"""Train goal-conditioned ObjectNav with DD-PPO on the hermetic GridNav env (port of
`examples/train_objectnav.py`).

    python -m embodied_clip_tpu_torch.examples.train_objectnav [--iters 200] [--frames]
        [--encoder clip_rn50] [--int8] [--device cuda|cpu] [--mesh]

Each iteration collects `--rollout` steps of `--env-batch` envs (with `--frames` the env
renders uint8 frames and the frozen encoder runs inside the rollout) and runs 4 PPO
epochs. Runs on the GPU unless `--device cpu`. With `--mesh`, each process of a
torch.distributed group (`ECT_COORDINATOR`, `ECT_NUM_PROCESSES`, `ECT_PROCESS_ID`) owns a
slice of the env batch and the gradients are all-reduced.
"""

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--env-batch", type=int, default=32)
    p.add_argument("--rollout", type=int, default=64)
    p.add_argument("--frames", action="store_true",
                   help="uint8 frame observations + a frozen encoder in-rollout")
    p.add_argument("--encoder", default="clip_rn50",
                   help="frozen encoder for --frames (a ported ENCODER_SPECS name)")
    p.add_argument("--int8", action="store_true",
                   help="serve the frozen encoder int8 (PTQ trunk, kernels K2/K3/K5)")
    p.add_argument("--mesh", action="store_true",
                   help="split the env batch over the processes of a torch.distributed "
                        "group (DD-PPO)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from embodied_clip_tpu_torch.envs.gridworld import GridNavEnv
    from embodied_clip_tpu_torch.models.policy import ActorCritic
    from embodied_clip_tpu_torch.parallel import mesh
    from embodied_clip_tpu_torch.parallel.distributed import initialize_distributed
    from embodied_clip_tpu_torch.training.ddppo import DDPPOConfig, DDPPOLearner
    from embodied_clip_tpu_torch.training.ppo import PPOConfig

    if args.mesh:
        initialize_distributed(device=args.device)
        print(f"process {mesh.rank()} of {mesh.world_size()}")
    env = GridNavEnv(size=8, max_steps=64, frame_obs=args.frames, flat_obs=not args.frames)
    encode = None
    visual_is_map, visual_shape = False, (env.view * env.view * env.obs_channels,)
    if args.frames:
        from embodied_clip_tpu_torch.training.frames import frozen_encode_fn

        encode, visual_is_map = frozen_encode_fn(args.encoder, torch.bfloat16,
                                                 int8=args.int8, device=args.device)
        visual_shape = encode.feature_shape
    policy = ActorCritic(env.num_actions, visual_shape, goal_kind="object_embed",
                         num_goal_classes=env.num_classes, hidden=512,
                         visual_is_map=visual_is_map)
    learner = DDPPOLearner(env, policy, DDPPOConfig(
        rollout_len=args.rollout, env_batch=args.env_batch,
        ppo=PPOConfig(lr=3e-4, epochs=4)), encode_fn=encode, device=args.device)

    def sync():
        if learner.device.type == "cuda":
            torch.cuda.synchronize(learner.device)

    generator = torch.Generator(device=learner.device).manual_seed(1 + mesh.rank())
    act = learner.init(generator)
    act, m = learner.train_iteration(act, generator)  # first call: kernel builds
    sync()
    t0 = time.perf_counter()
    for it in range(args.iters):
        act, m = learner.train_iteration(act, generator)
        if (it + 1) % 20 == 0:
            steps = (it + 1) * args.rollout * args.env_batch
            print(f"iter {it + 1}: success={float(m['success']):.2f} "
                  f"spl={float(m['spl']):.2f} entropy={float(m['entropy']):.2f} "
                  f"({steps / (time.perf_counter() - t0):.0f} env-steps/s)")
    sync()
    steps = args.iters * args.rollout * args.env_batch
    print(f"final: success={float(m['success']):.2f} loss={float(m['loss']):.4f} "
          f"{steps / (time.perf_counter() - t0):.0f} env-steps/s (after the first "
          f"iteration)")


if __name__ == "__main__":
    main()
