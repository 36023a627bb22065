"""Typed configuration (the port's own copy of the dataclasses of
text2loc_tpu/config.py and its small_test_config, with the same fields and
defaults). The port's functions read these fields from whatever object they
are given, so a JAX package Config with the same values works as well."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class PointNetConfig:
    """PointNet++ backbone; ratio 0.5 on 256 points gives the fixed ladder
    256 -> 128 -> 64 -> 32."""

    num_points: int = 256
    sa_num_points: Tuple[int, ...] = (128, 64, 32)
    sa_radii: Tuple[float, ...] = (0.2, 0.3, 0.4)
    sa_max_neighbors: int = 32
    sa_mlps: Tuple[Tuple[int, ...], ...] = ((6, 32, 64), (67, 128, 128), (131, 256, 256))
    global_mlp: Tuple[int, ...] = (259, 512, 1024)
    head_dims: Tuple[int, int] = (512, 256)
    features_level: int = 2
    freeze: bool = False


@dataclass(frozen=True)
class ModelConfig:
    coarse_embed_dim: int = 256
    fine_embed_dim: int = 128
    use_features: Tuple[str, ...] = ("class", "color", "position", "num")
    class_embed: bool = False
    color_embed: bool = False
    object_size: int = 28
    pad_size: int = 16
    num_mentioned: int = 6
    text_embed_dim: int = 1024
    max_hint_tokens: int = 16
    intra_num_layers: int = 1
    intra_num_heads: int = 4
    inter_num_layers: int = 1
    inter_num_heads: int = 4
    fine_intra_num_layers: int = 1
    fine_intra_num_heads: int = 4
    object_inter_num_layers: int = 2
    object_inter_num_heads: int = 4
    fine_num_decoder_layers: int = 2
    fine_num_decoder_heads: int = 4
    mask_padded: bool = True
    dropout_rate: float = 0.1
    dtype: str = "bfloat16"               # inference compute dtype
    train_dtype: str = "float32"          # training compute dtype
    body_dtype: Optional[str] = None      # ObjectEncoder + PointNet only
    pointnet: PointNetConfig = field(default_factory=PointNetConfig)


@dataclass(frozen=True)
class LossConfig:
    ranking_loss: str = "contrastive"     # contrastive|pairwise|hardest|triplet
    temperature: float = 0.1
    margin: float = 0.35
    hardest_scale: float = 64.0
    global_batch: bool = True


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    epochs: int = 16
    learning_rate: float = 1e-3
    lr_scheduler: str = "exponential"     # exponential|step
    lr_gamma: float = 1.0
    lr_step: int = 10
    optimizer: str = "adam"
    seed: int = 0
    offset_lambda: float = 5.0
    warmup_epochs: int = 3
    warmup_lr: float = 1e-5
    pmc_prob: float = 0.0
    pmc_threshold: float = 0.4
    pmc_count_threshold: int = 1
    shuffle_hints: bool = True
    flip_poses: bool = True
    fine_flip_poses: bool = True
    pc_augment: bool = True
    sample_close_cell: bool = False
    top_k: Tuple[int, ...] = (1, 3, 5)
    loss: LossConfig = field(default_factory=LossConfig)


@dataclass(frozen=True)
class EvalConfig:
    top_k: Tuple[int, ...] = (1, 3, 5, 10)
    threshs: Tuple[float, ...] = (5.0, 10.0, 15.0)
    batch_size: int = 32
    use_test_set: bool = False
    sentence_table: bool = False


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    base_path: str = ""
    checkpoint_dir: str = "./checkpoints"

    def validate(self) -> "Config":
        if self.train.loss.ranking_loss not in ("contrastive", "pairwise", "hardest",
                                                "triplet"):
            raise ValueError(self.train.loss.ranking_loss)
        for feat in self.model.use_features:
            if feat not in ("class", "color", "position", "num"):
                raise ValueError(feat)
        if self.train.lr_scheduler not in ("exponential", "step"):
            raise ValueError(self.train.lr_scheduler)
        if self.model.pointnet.features_level not in (0, 1, 2):
            raise ValueError(self.model.pointnet.features_level)
        return self

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


def small_test_config() -> Config:
    """A tiny configuration for unit tests and CPU smoke runs."""
    pn = PointNetConfig(
        num_points=16,
        sa_num_points=(8, 4, 2),
        sa_mlps=((6, 8, 16), (19, 16, 32), (35, 32, 32)),
        sa_max_neighbors=4,
        global_mlp=(35, 32, 64),
        head_dims=(48, 32),
    )
    model = ModelConfig(
        coarse_embed_dim=32,
        fine_embed_dim=16,
        object_size=8,
        pad_size=6,
        num_mentioned=3,
        text_embed_dim=64,
        max_hint_tokens=8,
        object_inter_num_layers=1,
        fine_num_decoder_layers=2,
        dtype="float32",
        pointnet=pn,
    )
    train = TrainConfig(batch_size=4, epochs=1, top_k=(1, 2))
    return Config(model=model, train=train).validate()
