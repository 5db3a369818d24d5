"""Dataset factory (port of din_tpu/data/datasets.py:14-57; reference
dataset.py:7-50 ``return_dataset``)."""

from __future__ import annotations

from din_tpu_torch.data.collective import (CollectiveDataset,
                                           collective_all_frames,
                                           collective_read_dataset)
from din_tpu_torch.data.packed import make_frame_source
from din_tpu_torch.data.synthetic import SyntheticDataset
from din_tpu_torch.data.volleyball import (VolleyballDataset, load_tracks,
                                           volley_all_frames,
                                           volley_read_dataset)


def return_dataset(cfg):
    """(train_set, val_set) for cfg: the synthetic fixtures for
    ``data_path == "synthetic"``, else the Volleyball or Collective
    Activity tree (or its packed store, ``cfg.packed_frames_path``) at
    ``cfg.data_path``."""
    if cfg.data_path == "synthetic":
        return (SyntheticDataset(cfg, is_training=True, seed=1),
                SyntheticDataset(cfg, size=16, is_training=False, seed=2))

    if cfg.dataset_name == "volleyball":
        train_anns = volley_read_dataset(cfg.data_path, cfg.train_seqs)
        train_frames = volley_all_frames(train_anns)
        test_anns = volley_read_dataset(cfg.data_path, cfg.test_seqs)
        test_frames = volley_all_frames(test_anns)
        common = dict(anns={**train_anns, **test_anns},
                      tracks=load_tracks(cfg.data_path),
                      images_path=cfg.data_path, image_size=cfg.image_size,
                      feature_size=cfg.out_size,
                      inference_module_name=cfg.inference_module_name,
                      num_boxes=cfg.num_boxes, num_before=cfg.num_before,
                      num_after=cfg.num_after,
                      is_finetune=(cfg.training_stage == 1),
                      hflip_prob=cfg.hflip_prob,
                      cache=make_frame_source(cfg))  # shared by train+val
        return (VolleyballDataset(frames=train_frames, is_training=True,
                                  **common),
                VolleyballDataset(frames=test_frames, is_training=False,
                                  **common))

    if cfg.dataset_name == "collective":
        train_anns = collective_read_dataset(cfg.data_path, cfg.train_seqs)
        test_anns = collective_read_dataset(cfg.data_path, cfg.test_seqs)
        common = dict(images_path=cfg.data_path, image_size=cfg.image_size,
                      feature_size=cfg.out_size, num_boxes=cfg.num_boxes,
                      num_frames=cfg.num_frames,
                      is_finetune=(cfg.training_stage == 1),
                      hflip_prob=cfg.hflip_prob,
                      cache=make_frame_source(cfg))  # shared by train+val
        return (CollectiveDataset(anns=train_anns,
                                  frames=collective_all_frames(train_anns),
                                  is_training=True, **common),
                CollectiveDataset(anns=test_anns,
                                  frames=collective_all_frames(test_anns),
                                  is_training=False, **common))

    raise ValueError(f"unknown dataset {cfg.dataset_name}")
