"""Training entry point of the port (port of din_tpu/experiments/run.py).

    python -m din_tpu_torch.experiments.run --preset volleyball_stage1 \
        --data-path synthetic --max-epoch 1 --max-steps-per-epoch 3 \
        --exp-name s1
    python -m din_tpu_torch.experiments.run \
        --preset volleyball_stage2_dynamic --data-path synthetic \
        --max-epoch 1 --max-steps-per-epoch 3 \
        --stage1-model-path "result/s1/stage1_epoch1_<acc>%.pth"

Trains on the card unless ``--device cpu`` is given (with no card it
raises).  Writes ``<result-root>/<exp-name>/log.txt`` and, per eval, one
``stage2_epoch{E}_{acc}%.pth`` (stage 2) or, at a best or tied accuracy,
one stage-1 component file ``stage1_epoch{E}_{acc}%.pth`` (stage 1).
``--stage1-model-path`` names the stage-1 file whose backbone and fc_emb
stage 2 starts from (the flagship preset grafts one by default);
``--stage2-model-path`` resumes a stage-2 file instead (params, Adam state
and epoch), as in the JAX package's run.py:78-83.  ``--pretrained-backbone-
path`` starts stage 1 from a torchvision ``state_dict`` file of the
preset's backbone (Inception-v3, VGG-16/19, ResNet-18/50 or AlexNet);
``--ref-checkpoint-path`` grafts a ``.pth`` saved by the reference framework
and ``--ref-resume-optimizer`` continues its training where it stopped
(run.py:24-30,59-61).

``--data-path`` names a Volleyball tree (``<root>/<sid>/annotations.txt``,
``<sid>/<src_fid>/<fid>.jpg``, ``tracks_normalized.pkl``), a Collective
Activity tree (``<root>/seqNN/annotations.txt``,
``seqNN/frameNNNN.jpg``) or ``synthetic``;
``--packed-frames-path`` reads its frames from a store packed by
``python -m din_tpu_torch.data.packed``; ``--hflip-prob`` mirrors training
clips with the left/right activity swap; ``--eval-only`` scores the loaded
weights (``--stage2-model-path``, ``--ref-checkpoint-path``, ...) on the
test split and trains nothing (run.py:94-103):

    python -m din_tpu_torch.experiments.run \
        --preset volleyball_stage2_dynamic --data-path data/volleyball/videos \
        --stage2-model-path result/exp/stage2_epoch3_91.20%.pth --eval-only

A run that may be preempted: a fixed ``--exp-name``, and ``--auto-resume``
on every launch.  SIGTERM makes the running epoch save its full state at
the next step boundary (``stage2_epoch{E}_preempt.pth``) and return; the
next launch continues that epoch at its next batch, bit for bit on the
CPU.  ``--train-to-epoch`` makes the last epoch absolute, so relaunches
finish the plan instead of adding ``--max-epoch`` each time;
``--grad-accum-steps k`` splits each batch into k micro-batches with one
Adam step on their averaged gradient:

    python -m din_tpu_torch.experiments.run \
        --preset volleyball_stage2_dynamic --data-path data/volleyball/videos \
        --exp-name flagship --auto-resume --train-to-epoch 30 \
        --batch-size 4 --grad-accum-steps 2

More than one rank: the same command under ``torch.distributed.run``, one
process per card, joins the ranks (``parallel/multihost.py``: NCCL on the
card, gloo with ``--device cpu``); ``--batch-size`` is one rank's batch,
``--shard-opt-state`` shards the Adam moments over the ranks (ZeRO-1), and
rank 0 alone writes the log and the checkpoints.  With no launcher the run
is one process, as above:

    python -m torch.distributed.run --nproc_per_node 4 \
        -m din_tpu_torch.experiments.run \
        --preset volleyball_stage2_dynamic --data-path data/volleyball/videos \
        --exp-name flagship4 --auto-resume --shard-opt-state

The Collective Activity path (T=10, 13 actors): stage 1 is Inception-v3
(``--preset collective_stage1``); stage 2 is ResNet-18, so its stage 1 is
``collective_stage1().replace(backbone="res18", out_size=(15, 23),
emb_features=512)`` through ``train_net``, whose component file stage 2
grafts:

    python -m din_tpu_torch.experiments.run \
        --preset collective_stage2_dynamic --data-path data/collective \
        --stage1-model-path result/basemodel_CAD_res18.pth
"""

from __future__ import annotations

import argparse
import os

from din_tpu_torch.experiments.presets import PRESETS


def config_from_args(argv=None):
    """(cfg, args) of the command line."""
    p = argparse.ArgumentParser(description="din_tpu_torch training")
    p.add_argument("--preset", required=True, choices=sorted(PRESETS))
    p.add_argument("--data-path", default=None)
    p.add_argument("--max-epoch", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--max-steps-per-epoch", type=int, default=None)
    p.add_argument("--stage1-model-path", default=None,
                   help="stage-1 component .pth to graft into stage 2")
    p.add_argument("--stage2-model-path", default=None,
                   help="stage-2 .pth of the port to resume from")
    p.add_argument("--ref-checkpoint-path", default=None,
                   help=".pth saved by the reference framework to graft in "
                        "(nn/ref_import.py)")
    p.add_argument("--ref-resume-optimizer", action="store_true",
                   help="also adopt the torch Adam moments/step/lr of the "
                        "reference full checkpoint and resume at its epoch "
                        "+ 1")
    p.add_argument("--pretrained-backbone-path", default=None,
                   help="torchvision state_dict file for the backbone's "
                        "ImageNet init (stage 1)")
    p.add_argument("--packed-frames-path", default=None,
                   help="store of decoded frames read in place of the JPEGs "
                        "(python -m din_tpu_torch.data.packed)")
    p.add_argument("--hflip-prob", type=float, default=None,
                   help="train-time horizontal-flip probability (beyond "
                        "the reference; keep unset for parity)")
    p.add_argument("--eval-only", action="store_true",
                   help="one eval pass on the loaded weights and exit, no "
                        "training")
    p.add_argument("--result-root", default=None)
    p.add_argument("--exp-name", default=None,
                   help="fixed result dir name (required for "
                        "--auto-resume across relaunches; default is "
                        "timestamped)")
    p.add_argument("--auto-resume", action="store_true",
                   help="resume the newest checkpoint in the result dir "
                        "(incl. SIGTERM _preempt saves — train/preempt.py)")
    p.add_argument("--train-to-epoch", type=int, default=None,
                   help="absolute stop epoch (overrides max_epoch; pair "
                        "with --auto-resume so relaunches complete the "
                        "original plan)")
    p.add_argument("--grad-accum-steps", type=int, default=None,
                   help="micro-batches per optimizer update (large-batch "
                        "gradients at micro-batch memory)")
    p.add_argument("--shard-opt-state", action="store_true",
                   help="ZeRO-1: shard the Adam moments over the data "
                        "ranks (more than one rank)")
    p.add_argument("--device", default=None,
                   help="default: the card (cuda; a rank's own under "
                        "torch.distributed.run); 'cpu' only when asked")
    args = p.parse_args(argv)

    cfg = PRESETS[args.preset]()
    overrides = {}
    if args.data_path is not None:
        overrides["data_path"] = args.data_path
    if args.max_epoch is not None:
        overrides["max_epoch"] = args.max_epoch
    if args.batch_size is not None:
        overrides["batch_size"] = args.batch_size
    if args.stage1_model_path:
        overrides["stage1_model_path"] = args.stage1_model_path
    if args.stage2_model_path:
        overrides["stage2model"] = args.stage2_model_path
        overrides["load_stage2model"] = True
        overrides["load_backbone_stage2"] = False
    if args.ref_checkpoint_path:
        overrides["ref_checkpoint_path"] = args.ref_checkpoint_path
    if args.ref_resume_optimizer:
        overrides["ref_resume_optimizer"] = True
    if args.pretrained_backbone_path:
        overrides["pretrained_backbone_path"] = args.pretrained_backbone_path
    if args.packed_frames_path:
        overrides["packed_frames_path"] = args.packed_frames_path
    if args.hflip_prob is not None:
        overrides["hflip_prob"] = args.hflip_prob
    if args.eval_only:
        overrides["eval_only"] = True
    if args.result_root:
        overrides["result_root"] = args.result_root
    if args.exp_name:
        overrides["exp_name"] = args.exp_name
    if args.auto_resume:
        overrides["auto_resume"] = True
    if args.train_to_epoch is not None:
        overrides["train_to_epoch"] = args.train_to_epoch
    if args.grad_accum_steps is not None:
        overrides["grad_accum_steps"] = args.grad_accum_steps
    if args.shard_opt_state:
        overrides["shard_opt_state"] = True
    return cfg.replace(**overrides), args


def main(argv=None):
    from din_tpu_torch.parallel.multihost import (initialize_multihost,
                                                  shutdown_multihost)
    from din_tpu_torch.train.engine import train_net
    from din_tpu_torch.utils.logging import is_log_rank

    cfg, args = config_from_args(argv)
    # a rank of torch.distributed.run joins its peers first
    launched = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    if launched:
        initialize_multihost(device=args.device)
    try:
        best = train_net(cfg, max_steps_per_epoch=args.max_steps_per_epoch,
                         device=args.device)
        if is_log_rank():
            print("Best:", {k: v for k, v in best.items()
                            if not hasattr(v, "shape")})
    finally:
        if launched:
            shutdown_multihost()
    return best


if __name__ == "__main__":
    main()
