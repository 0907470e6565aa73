"""ViT — vision transformer classifier, counterpart of
``kubeflow_tpu/models/vit.py``.

Patchify by reshape and transpose, embed the flattened patches with one
Dense, prepend a (zero-initialised) CLS token, add a learned position
embedding, run the BERT encoder block (``models/bert.py`` ``BertLayer``)
under an all-ones mask (a zero bias), and classify from the CLS token after
a final LayerNorm. Attention is "dense" or "flash"; the sequence is
patches + CLS, always odd (197 at 224²/16), so the flash kernels run it
with a ragged last tile.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from kubeflow_tpu_torch.models.bert import BertConfig, BertLayer
from kubeflow_tpu_torch.models.layers import (
    DTYPES,
    Dense,
    LayerNorm,
    block_seeds,
    dropout,
    init_module_weights,
    with_compute_dtype,
)
from kubeflow_tpu_torch.utils.device import select_device


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    dropout_rate: float = 0.1
    dtype: str = "float32"      # compute dtype: float32 | bfloat16
    attention: str = "dense"    # dense | flash
    attention_block: int = 128

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError(
                f"image_size {self.image_size} not divisible by "
                f"patch_size {self.patch_size}"
            )
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"hidden_size {self.hidden_size} not divisible by "
                f"num_heads {self.num_heads}"
            )
        if self.dtype not in DTYPES:
            raise ValueError(
                f"dtype {self.dtype!r} is not one of {sorted(DTYPES)}")

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def encoder_config(self) -> BertConfig:
        """The BertLayer-compatible view of this config (seq = patches+CLS)."""
        return BertConfig(
            vocab_size=2,  # unused by the encoder blocks
            hidden_size=self.hidden_size,
            num_layers=self.num_layers,
            num_heads=self.num_heads,
            mlp_dim=self.mlp_dim,
            max_len=self.num_patches + 1,
            dropout_rate=self.dropout_rate,
            dtype=self.dtype,
            attention=self.attention,
            attention_block=self.attention_block,
        )

    @staticmethod
    def base(**kw) -> "ViTConfig":
        return ViTConfig(**kw)  # ViT-B/16 shape

    @staticmethod
    def tiny(**kw) -> "ViTConfig":
        d = dict(image_size=32, patch_size=8, num_classes=10, hidden_size=64,
                 num_layers=2, num_heads=4, mlp_dim=128)
        d.update(kw)
        return ViTConfig(**d)


class ViTClassifier(nn.Module):
    """images (B, H, W, C) -> class logits (B, num_classes) float32.
    ``in_channels`` is C (flax reads it off the first input)."""

    PREFERRED_COMPUTE_DTYPE = "bfloat16"

    def __init__(self, cfg: ViTConfig, in_channels: int = 3,
                 device: str | torch.device = "cuda"):
        super().__init__()
        if cfg.attention not in ("dense", "flash"):
            raise ValueError(
                f"ViT attention {cfg.attention!r} is not dense|flash: the "
                "sequence (patches + CLS) is odd and cannot shard a context "
                "axis")
        dev, dt = select_device(device), cfg.torch_dtype
        self.cfg = cfg
        p = cfg.patch_size
        self.patch_embed = Dense(p * p * in_channels, cfg.hidden_size, True,
                                 dt, dev)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size,
                                                  device=dev))
        self.position_embed = nn.Parameter(torch.zeros(
            1, cfg.num_patches + 1, cfg.hidden_size, device=dev))
        ecfg = cfg.encoder_config()
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertLayer(ecfg, dev))
        self.ln_final = LayerNorm(cfg.hidden_size, compute_dtype=dt,
                                  device=dev)
        self.head = Dense(cfg.hidden_size, cfg.num_classes, True, dt, dev)

    def init_weights(self, generator: torch.Generator) -> "ViTClassifier":
        """flax's defaults; the CLS token 0, the position embedding
        N(0, 0.02)."""
        init_module_weights(self, generator)
        with torch.no_grad():
            self.cls_token.zero_()
            self.position_embed.copy_(0.02 * torch.randn(
                self.position_embed.shape, generator=generator,
                device=generator.device))
        return self

    with_compute_dtype = with_compute_dtype

    def forward(self, images: torch.Tensor, train: bool = False,
                generator=None) -> torch.Tensor:
        c = self.cfg
        dt = c.torch_dtype
        b, h, w, ch = images.shape
        p = c.patch_size
        if (h, w) != (c.image_size, c.image_size):
            raise ValueError(
                f"expected {c.image_size}x{c.image_size} images, got {h}x{w}")
        seeds = block_seeds(c.num_layers + 1, train, c.dropout_rate,
                            generator, images.device)
        # patchify as reshape + transpose, embed as one matmul
        x = images.to(dt).reshape(b, h // p, p, w // p, p, ch)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, c.num_patches, p * p * ch)
        x = self.patch_embed(x)
        cls = self.cls_token.to(dt).expand(b, 1, c.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.position_embed.to(dt)
        x = dropout(x, c.dropout_rate if train else 0.0, seeds[0])
        bias = torch.zeros((b, 1, 1, c.num_patches + 1), dtype=dt,
                           device=x.device)  # no padding in images
        for i, seed in enumerate(seeds[1:]):
            x = getattr(self, f"layer_{i}")(x, bias, train, seed)
        x = self.ln_final(x)
        return self.head(x[:, 0]).float()
