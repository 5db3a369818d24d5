"""Experiment configuration of the port.

A copy of the fields of din_tpu/config.py ``Config`` that the serving,
training and data slices read, with the same names, defaults and meanings
(reference config.py:5-116), and of its Volleyball and Collective splits.
TPU-only knobs and those of unported parts are left out; they join as the
slices that read them are ported (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Volleyball split (reference config.py:28-30; din_tpu/config.py:21-26)
VOLLEYBALL_TRAIN_SEQS = [
    1, 3, 6, 7, 10, 13, 15, 16, 18, 22, 23, 31, 32, 36, 38, 39, 40, 41, 42,
    48, 50, 52, 53, 54, 0, 2, 8, 12, 17, 19, 24, 26, 27, 28, 30, 33, 46, 49,
    51,
]
VOLLEYBALL_TEST_SEQS = [4, 5, 9, 11, 14, 20, 21, 25, 29, 34, 35, 37, 43, 44,
                        45, 47]

# Collective split (reference config.py:33-34)
COLLECTIVE_TEST_SEQS = [5, 6, 7, 8, 9, 10, 11, 15, 16, 25, 28, 29]
COLLECTIVE_TRAIN_SEQS = [s for s in range(1, 45)
                         if s not in COLLECTIVE_TEST_SEQS]


@dataclasses.dataclass
class Config:
    """Knobs of the ported slices; semantics follow reference config.py."""

    dataset_name: str = "volleyball"

    # geometry (reference config.py:12-15)
    image_size: Tuple[int, int] = (720, 1280)       # input image H, W
    batch_size: int = 32                            # train batch size
    test_batch_size: int = 8                        # eval batch size
    num_boxes: int = 12                             # actors per frame

    # data (reference config.py:22-34): a Volleyball tree
    # (<root>/<sid>/annotations.txt, <sid>/<src_fid>/<fid>.jpg,
    # tracks_normalized.pkl), or "synthetic" for the fixture dataset
    data_path: str = "data/volleyball/videos"
    train_seqs: Sequence[int] = dataclasses.field(default_factory=list)
    test_seqs: Sequence[int] = dataclasses.field(default_factory=list)

    # backbone (reference config.py:36-41)
    backbone: str = "res18"
    crop_size: Tuple[int, int] = (5, 5)             # RoIAlign K x K
    train_backbone: bool = False
    out_size: Tuple[int, int] = (87, 157)           # feature map OH, OW
    emb_features: int = 1056                        # backbone channels D

    # classes and losses (reference config.py:44-48)
    num_actions: int = 9
    num_activities: int = 8
    actions_loss_weight: float = 1.0
    actions_weights: Optional[Sequence[float]] = None  # per-class CE weights

    # frame sampling (reference config.py:50-53)
    num_frames: int = 3                             # T
    num_before: int = 5
    num_after: int = 4
    num_features_boxes: int = 1024                  # NFB

    # ARG head (reference config.py:55-62): ARG and GCNNet read them
    # (models/baselines.py); the collective and smoke presets set some
    num_features_relation: int = 256                # NFR
    num_graph: int = 16                             # NG
    num_features_gcn: int = 1024                    # NFG
    gcn_layers: int = 1
    tau_sqrt: bool = False
    # distance mask: actors farther apart than pos_threshold * OW (feature
    # pixels) are not related (gcn_model.py:48-56)
    pos_threshold: float = 0.2

    # training (reference config.py:64-72)
    train_random_seed: int = 0
    train_learning_rate: float = 1e-4
    lr_plan: Dict[int, float] = dataclasses.field(
        default_factory=lambda: {41: 1e-5})
    train_dropout_prob: float = 0.3
    weight_decay: float = 0.0
    max_epoch: int = 30
    # max_epoch counts epochs from the start epoch (reference semantics,
    # train_net.py:100, where the start is always 1); on auto_resume that
    # means "N more epochs", which would extend a repeatedly preempted run.
    # train_to_epoch is an absolute last epoch (consistent with the absolute
    # epoch keys of lr_plan) and overrides max_epoch (din_tpu/config.py:85-89)
    train_to_epoch: Optional[int] = None
    test_interval_epoch: int = 1

    # experiment control (reference config.py:74-81)
    training_stage: int = 1
    # an eval pass on the loaded weights before the first epoch, logged at
    # epoch 0 (reference train_net.py:93-95)
    test_before_train: bool = False
    # one eval pass on the loaded weights and no training, logged at the
    # start epoch - 1 (din_tpu/config.py:95-99)
    eval_only: bool = False
    exp_note: str = "Group-Activity-Recognition"
    exp_name: Optional[str] = None
    # True: BatchNorm normalises with its running statistics in training
    # too and never updates them (the trunk's bn_train = train and not
    # set_bn_eval; din_tpu/config.py:102)
    set_bn_eval: bool = False
    inference_module_name: str = "dynamic_volleyball"
    # stage 2 starts from a stage-1 component file (.pth, the reference's
    # base_model.py:46-54 layout): its backbone and fc_emb are grafted
    # (reference config.py:78,97; din_tpu/config.py:94,113)
    stage1_model_path: str = ""
    load_backbone_stage2: bool = False
    # a full stage-2 checkpoint of the port (.pth) to resume from
    load_stage2model: bool = False
    stage2model: Optional[str] = None
    # a .pth saved by the reference framework (full-model or stage-1
    # component format) grafted into the initialised model before the
    # stage-1/stage-2 loaders (din_tpu/config.py:119-124, nn/ref_import.py)
    ref_checkpoint_path: str = ""
    # also adopt the torch Adam moments, step and lr of that full-format
    # file and resume at its epoch + 1 (din_tpu/config.py:125-129)
    ref_resume_optimizer: bool = False
    # torchvision-layout state_dict file of the backbone (ImageNet init of
    # stage 1; din_tpu/config.py:180)
    pretrained_backbone_path: Optional[str] = None

    # Dynamic Inference / DIN (reference config.py:83-97)
    stride: int = 1
    ST_kernel_size: Any = ((3, 3),)
    dynamic_sampling: bool = True
    sampling_ratio: Sequence[int] = (1, 3)
    group: int = 1
    scale_factor: bool = True
    beta_factor: bool = True
    parallel_inference: bool = False
    hierarchical_inference: bool = False
    lite_dim: Optional[int] = None

    # Actor Transformer: attend over the frame-averaged actors instead of
    # each frame's (reference config.py:99-100)
    temporal_pooled_first: bool = False

    # SACRF + BiUTE's halting loss weight (reference config.py:102-103)
    halting_penalty: float = 1e-4

    # micro-batches per optimizer update: the batch is split into this many
    # equal micro-batches, each takes its forward and a backward of its loss
    # / grad_accum_steps (BatchNorm statistics carried micro-batch to
    # micro-batch), and Adam steps once on the averaged gradient; batch_size
    # must be divisible by it (din_tpu/config.py:157)
    grad_accum_steps: int = 1

    # more than one rank (one process each, torch.distributed;
    # din_tpu/config.py:140-179, parallel/mesh.py): the ranks laid out as
    # data x model, e.g. {"data": 2, "model": 2}; empty = every rank on
    # 'data'.  cfg.batch_size stays the batch of one data rank.
    mesh_shape: Dict[str, int] = dataclasses.field(default_factory=dict)
    # Sequence(frame) parallelism: the ranks of a model group split their
    # data group's B*T frames through the backbone and RoIAlign (frames
    # are independent there, models/trunk.py), and the RoI features are
    # gathered back to every rank of the group for the reasoning head.
    # Scales the backbone even at batch sizes data parallelism cannot split
    # (e.g. bs1).  Parameters stay replicated.
    frame_parallel: bool = False
    # ZeRO-1: the Adam moments sharded over the 'data' ranks
    # (torch.distributed.optim.ZeroRedundancyOptimizer): the same update,
    # optimizer memory per rank 2x params -> 2x/n_data.  No-op on one data
    # rank.
    shard_opt_state: bool = False
    # Shard-local frame-chunk packing over the frame ranks: 'auto' = each
    # rank packs its own frames into every chunk whenever that leaves the
    # numbers as they are (no live trunk BatchNorm), 'on' = also with live
    # BatchNorm (chunks regroup; their statistics are still reduced over
    # the ranks they span), 'off' = the order-preserving packing, where a
    # chunk may span ranks.  models/trunk.py.
    shard_local_chunks: str = "auto"

    # dtype of the backbone's convolutions; parameters and the head are f32
    compute_dtype: str = "bfloat16"
    frame_chunk: Optional[int] = None    # frames per backbone micro-batch
    result_root: str = "result"

    # host input pipeline (din_tpu/config.py:163,182-191)
    prefetch_depth: int = 2              # batches copied ahead of the step
    num_workers: int = 4                 # host decode threads
    decode_cache_mb: int = 0             # decoded-frame LRU budget (0 = off;
    # ~2.7 MB per 720p frame, data/cache.py)
    hflip_prob: float = 0.0              # train-time horizontal flip with
    # the l/r activity swap (data/augment.py), beyond the reference: keep
    # 0 for parity runs
    packed_frames_path: Optional[str] = None  # store of decoded frames
    # (data/packed.py; `python -m din_tpu_torch.data.packed`), read in
    # place of the JPEGs; takes precedence over decode_cache_mb

    # diagnostics and run control (din_tpu/config.py:193-203)
    measure_mad: bool = False            # MAD diagnostic on the DIN eval
    profile_dir: Optional[str] = None    # torch.profiler trace of the
    # first epoch written here (utils/profiling.py)
    debug_nans: bool = False             # anomaly mode with NaN checks
    # and a finite-loss check in each step, for the run only
    auto_resume: bool = False            # resume the newest resumable
    # checkpoint in result_path (train/checkpoint.py newest_resumable)
    graceful_preemption: bool = True     # SIGTERM -> save the full state at
    # the next step boundary and return (train/preempt.py); pair with
    # auto_resume to survive spot or maintenance reclaims
    keep_checkpoints: int = 0            # keep the newest K regular stage-2
    # files (+ the best-accuracy one; _preempt files are always kept); 0 =
    # keep all like the reference (train/checkpoint.py prune_checkpoints)

    # derived by init_config()
    result_path: Optional[str] = None
    log_path: Optional[str] = None

    def __post_init__(self):
        if self.dataset_name not in ("volleyball", "collective"):
            raise ValueError(f"unknown dataset {self.dataset_name!r}")
        if not self.train_seqs or not self.test_seqs:
            # the dataset's split and default root, as din_tpu sets them
            if self.dataset_name == "volleyball":
                self.train_seqs = list(VOLLEYBALL_TRAIN_SEQS)
                self.test_seqs = list(VOLLEYBALL_TEST_SEQS)
                self.data_path = "data/volleyball/videos"
            else:
                self.train_seqs = list(COLLECTIVE_TRAIN_SEQS)
                self.test_seqs = list(COLLECTIVE_TEST_SEQS)
                self.data_path = "data/collective"

    def init_config(self, need_new_folder: bool = True) -> "Config":
        """``result/<exp_name>/log.txt`` (reference config.py:107-116)."""
        if self.exp_name is None:
            time_str = time.strftime("%Y-%m-%d_%H-%M-%S", time.localtime())
            self.exp_name = "[%s_stage%d]<%s>" % (
                self.exp_note, self.training_stage, time_str)
        self.result_path = os.path.join(self.result_root, self.exp_name)
        self.log_path = os.path.join(self.result_path, "log.txt")
        if need_new_folder:
            os.makedirs(self.result_path, exist_ok=True)
        return self

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)

    @property
    def kernel_sizes(self) -> List[Tuple[int, int]]:
        """ST_kernel_size normalised to a list of (kh, kw): the reference
        accepts a list of tuples and a bare tuple."""
        ks = self.ST_kernel_size
        if isinstance(ks, int):
            return [(ks, ks)]
        ks = tuple(ks)
        if len(ks) == 2 and all(isinstance(v, int) for v in ks):
            return [tuple(ks)]
        return [tuple(k) for k in ks]

    @property
    def action_weight_list(self) -> Optional[List[float]]:
        """actions_weights flattened: the reference scripts pass a nested
        list ``[[...]]`` (scripts/train_volleyball_stage1.py:34)."""
        w = self.actions_weights
        if w is None:
            return None
        w = list(w)
        if len(w) and isinstance(w[0], (list, tuple)):
            w = list(w[0])
        return [float(v) for v in w]
