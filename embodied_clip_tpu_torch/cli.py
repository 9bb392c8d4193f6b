"""Single CLI for the port (port of `embodied_clip_tpu/cli.py`: the same subcommands,
flags, defaults and exit codes, plus `--device`).

  python -m embodied_clip_tpu_torch probe-train --embedding-type clip_avgpool \\
      --prediction-type object_presence --data-dir data --log-dir logs
      # reference: primitive_probing/train.py:116-174

  python -m embodied_clip_tpu_torch extract-features --data-dir data/ithor_scenes \\
      --output-dir data      # reference: generate_data/thor_image_features.py

  python -m embodied_clip_tpu_torch train --config <experiment> [--ckpt …] [--eval]
      # reference: allenact/main.py & habitat_baselines/run.py runbooks

Every subcommand that builds a module runs it on the card unless `--device cpu` is
given. Experiment configs are registered dataclasses (config/experiments.py).
"""

from __future__ import annotations

import argparse
import json
import sys

from embodied_clip_tpu_torch.models.probes import EMBEDDING_TYPES, PREDICTION_TYPES


def _device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="where the modules run: cuda (the default) or cpu")


def _cmd_probe_train(argv):
    p = argparse.ArgumentParser(prog="probe-train")
    p.add_argument("--data-dir", dest="data_dir", default="data")
    p.add_argument("--log-dir", dest="log_dir", default="logs/")
    p.add_argument("--embedding-type", dest="embedding_type",
                   choices=list(EMBEDDING_TYPES))
    p.add_argument("--prediction-type", dest="prediction_type",
                   choices=list(PREDICTION_TYPES))
    p.add_argument("--max-epochs", type=int, default=250)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ckpt-dir", dest="ckpt_dir", default=None)
    p.add_argument("--ckpt", default=None, help="restore params from checkpoint")
    p.add_argument("--eval", action="store_true", help="skip training; test only")
    _device_arg(p)
    args = p.parse_args(argv)
    if args.eval and not args.ckpt:
        # Without a checkpoint there is nothing to evaluate — scoring
        # randomly-initialized params would print meaningless metrics as if
        # they were a real result.
        p.error("--eval requires --ckpt (no trained parameters to test)")

    from embodied_clip_tpu_torch.data.probing import ProbeDataModule
    from embodied_clip_tpu_torch.training.supervised import ProbeTrainConfig, ProbeTrainer

    dm = ProbeDataModule(
        args.data_dir, args.embedding_type, args.prediction_type,
        batch_size=args.batch_size,
    ).setup()
    trainer = ProbeTrainer(ProbeTrainConfig(
        embedding_type=args.embedding_type,
        prediction_type=args.prediction_type,
        lr=args.lr, batch_size=args.batch_size, max_epochs=args.max_epochs,
        log_dir=args.log_dir, ckpt_dir=args.ckpt_dir, device=args.device,
    ))
    if args.ckpt:
        x0, _ = next(dm.batches("train", shuffle=False))
        trainer.load(args.ckpt, x0)
    result = {}
    if not args.eval:
        result["val"] = trainer.fit(dm)
    result["test"] = trainer.test(dm, use_best=not args.eval or args.ckpt is None)
    print(json.dumps(result))


def _cmd_extract_features(argv):
    p = argparse.ArgumentParser(prog="extract-features")
    p.add_argument("--data-dir", dest="data_dir", default="data/ithor_scenes")
    p.add_argument("--output-dir", dest="output_dir", default="data")
    p.add_argument("--encoders", default="imagenet_rn50,clip_rn50")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16", "int8"])
    _device_arg(p)
    args = p.parse_args(argv)

    from embodied_clip_tpu_torch.generate_data.extract import extract_thor_features

    extract_thor_features(
        args.data_dir, args.output_dir,
        encoder_names=args.encoders.split(","),
        batch_size=args.batch_size, dtype=args.dtype, device=args.device,
    )


def _cmd_train(argv):
    p = argparse.ArgumentParser(prog="train")
    p.add_argument("--config", required=True, help="registered experiment name")
    p.add_argument("--output-dir", dest="output_dir", default="storage")
    p.add_argument("--ckpt", default=None, help="checkpoint to load")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--override", nargs="*", default=[], help="key=value config overrides")
    p.add_argument("--profile-dir", dest="profile_dir", default=None,
                   help="capture a torch.profiler trace of the run into this directory "
                        "(TensorBoard/perfetto-viewable; pair with a small "
                        "total_env_steps override — the trace covers the whole command)")
    _device_arg(p)
    args = p.parse_args(argv)

    import contextlib

    from embodied_clip_tpu_torch.config.experiments import get_experiment
    from embodied_clip_tpu_torch.utils.profiling import trace

    exp = get_experiment(args.config, overrides=args.override)
    if not any(ov.partition("=")[0] == "device" for ov in args.override):
        exp.device = args.device
    if args.profile_dir:
        # Process-group bring-up comes before the trace starts, as in the JAX package
        # (a no-op when ECT_COORDINATOR et al are unset).
        from embodied_clip_tpu_torch.parallel.distributed import initialize_distributed

        initialize_distributed(device=exp.device)
    ctx = trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext()
    with ctx:
        if args.eval:
            result = exp.evaluate(output_dir=args.output_dir, ckpt=args.ckpt)
        else:
            result = exp.train(output_dir=args.output_dir, ckpt=args.ckpt)
    print(json.dumps(result))


def _cmd_convert_weights(argv):
    """torch checkpoint (openai CLIP / torchvision) → the port's state dict file."""
    p = argparse.ArgumentParser(prog="convert-weights")
    p.add_argument("--torch-checkpoint", required=True)
    p.add_argument("--encoder", required=True,
                   help="encoder name, e.g. clip_rn50 / imagenet_rn50 (see encoders.ENCODER_SPECS)")
    p.add_argument("--output", required=True, help="output state-dict file (.pt)")
    p.add_argument("--fold-bn", action="store_true", help="also fold frozen BN")
    _device_arg(p)
    args = p.parse_args(argv)

    from embodied_clip_tpu_torch.models.encoders import build_encoder
    from embodied_clip_tpu_torch.utils.checkpoint import save_pytree

    enc = build_encoder(args.encoder, torch_checkpoint=args.torch_checkpoint,
                        device=args.device)
    if args.fold_bn:
        enc = enc.fold_bn()
    save_pytree(args.output, {k: v.cpu() for k, v in enc.module.state_dict().items()})
    print(json.dumps({"encoder": args.encoder, "output": args.output,
                      "folded": args.fold_bn}))


def _cmd_convert_policy(argv):
    """Released allenact RoboTHOR ObjectNav `.pt` → the port's checkpoint
    (readme_files/baselines_robothor_objectnav.md:54-68's pretrained models).
    Evaluate with: train --config <objectnav exp> --override policy_arch=allenact
    --ckpt <output> --eval."""
    p = argparse.ArgumentParser(prog="convert-policy")
    p.add_argument("--torch-checkpoint", required=True,
                   help="released allenact .pt (ResnetTensorNavActorCritic)")
    p.add_argument("--output", required=True, help="output checkpoint file (.pt)")
    p.add_argument("--grid", type=int, default=7,
                   help="frozen conv-map side (7 for RN50 @ 224px)")
    _device_arg(p)
    args = p.parse_args(argv)

    from embodied_clip_tpu_torch.models.allenact_policy import (
        allenact_config,
        load_allenact_checkpoint,
    )
    from embodied_clip_tpu_torch.utils.checkpoint import save_pytree

    policy = load_allenact_checkpoint(args.torch_checkpoint, grid=args.grid,
                                      device=args.device)
    config = allenact_config(policy.state_dict(), args.grid)
    # The architecture config rides along so eval can rebuild the exact module
    # (dims of the released models differ from native ActorCritic defaults).
    save_pytree(args.output, {"params": {k: v.cpu() for k, v in policy.state_dict().items()},
                              "allenact_config": config})
    print(json.dumps({"output": args.output, "config": config}))


def _cmd_probe_sweep(argv):
    """Run the full probing grid (the readme's EMB_TYPE × PRED_TYPE sweep loops)."""
    p = argparse.ArgumentParser(prog="probe-sweep")
    p.add_argument("--data-dir", dest="data_dir", default="data")
    p.add_argument("--log-dir", dest="log_dir", default="logs/")
    p.add_argument("--max-epochs", type=int, default=250)
    p.add_argument("--output", default=None, help="write results JSON here")
    _device_arg(p)
    args = p.parse_args(argv)

    from embodied_clip_tpu_torch.data.probing import ProbeDataModule
    from embodied_clip_tpu_torch.training.supervised import ProbeTrainConfig, ProbeTrainer

    results = {}
    for pred in PREDICTION_TYPES:
        embs = ("imagenet_avgpool", "clip_avgpool") if pred == "object_localization" \
            else EMBEDDING_TYPES
        for emb in embs:
            dm = ProbeDataModule(args.data_dir, emb, pred).setup()
            tr = ProbeTrainer(ProbeTrainConfig(
                embedding_type=emb, prediction_type=pred,
                max_epochs=args.max_epochs, log_dir=args.log_dir, device=args.device))
            tr.fit(dm)
            results[f"{pred}/{emb}"] = tr.test(dm)
    out = json.dumps(results, indent=2)
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
    print(out)


def _cmd_verify_parity(argv):
    """North-star fidelity check vs reference activations (BASELINE.json: ≤1e-3
    cosine). Capture the reference side with tools/capture_reference_activations.py,
    then run this with the real weights; exits nonzero on failure."""
    p = argparse.ArgumentParser(prog="verify-parity")
    p.add_argument("--encoder", required=True)
    p.add_argument("--activations", required=True,
                   help=".npz from tools/capture_reference_activations.py")
    p.add_argument("--torch-checkpoint", default=None,
                   help="reference weights to convert (state_dict / jit archive)")
    p.add_argument("--variables", default=None,
                   help="an already-converted state-dict file (convert-weights)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16", "int8"])
    p.add_argument("--threshold", type=float, default=1e-3)
    _device_arg(p)
    args = p.parse_args(argv)

    from embodied_clip_tpu_torch.parity import verify_encoder_parity

    result = verify_encoder_parity(
        args.encoder, args.activations,
        torch_checkpoint=args.torch_checkpoint, variables=args.variables,
        dtype=args.dtype, threshold=args.threshold, device=args.device,
    )
    print(json.dumps(result, indent=2))
    if not result["pass"]:
        sys.exit(1)


def _cmd_list_configs(argv):
    from embodied_clip_tpu_torch.config.experiments import list_experiments

    for name in list_experiments():
        print(name)


COMMANDS = {
    "probe-train": _cmd_probe_train,
    "probe-sweep": _cmd_probe_sweep,
    "extract-features": _cmd_extract_features,
    "convert-weights": _cmd_convert_weights,
    "convert-policy": _cmd_convert_policy,
    "verify-parity": _cmd_verify_parity,
    "train": _cmd_train,
    "list-configs": _cmd_list_configs,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("commands:", ", ".join(COMMANDS))
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; available: {', '.join(COMMANDS)}", file=sys.stderr)
        return 2
    COMMANDS[cmd](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
