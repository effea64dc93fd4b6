"""CLIP towers (counterpart of ``panacea_tpu/models/clip.py``; reference
modules.py:385, 559-720).

  * ``CLIPTextTransformer``: token + positional embedding, pre-LN causal
    blocks, the output of the penultimate block (the last is skipped) or of
    the last, then ln_final. ``FrozenOpenCLIPEmbedder`` is the ViT-H-14 text
    tower of the generation path (exact gelu); ``FrozenCLIPEmbedder`` is
    OpenAI's CLIP-L (width 768, 12 heads, 12 layers, quick_gelu).
  * ``CLIPVisionTransformer``: a bias-free patch convolution, the class
    token, ln_pre, unmasked blocks, ln_post and the pooled projection;
    ``FrozenOpenCLIPImageEmbedder`` resizes to 224 as ``jax.image.resize``
    does (Keys bicubic, antialiased) and normalises with OpenAI's mean and
    std.

Names follow open_clip: the attention packs q/k/v as
``in_proj_weight``/``in_proj_bias``; the image embedder's tower sits under
``model.visual``.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from panacea_tpu_torch.data.tokenizer import CONTEXT_LENGTH, SimpleTokenizer
from panacea_tpu_torch.ops.resize import resize

ACTS = ("gelu", "quick_gelu")


class QuickGELU(nn.Module):
    """OpenAI CLIP's activation, x * sigmoid(1.702 x)."""

    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int, causal: bool = True):
        super().__init__()
        self.heads = heads
        self.causal = causal
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, w = x.shape
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(b, s, self.heads, -1).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        out = F.scaled_dot_product_attention(q, k, v, is_causal=self.causal)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, w))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, act: str = "gelu", causal: bool = True):
        super().__init__()
        if act not in ACTS:
            raise ValueError(f"unknown activation {act!r}, not one of {ACTS}")
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = CLIPAttention(width, heads, causal)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, 4 * width)),
            ("gelu", QuickGELU() if act == "quick_gelu" else nn.GELU()),
            ("c_proj", nn.Linear(4 * width, width))]))

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, heads: int, layers: int, act: str = "gelu",
                 causal: bool = True):
        super().__init__()
        self.resblocks = nn.ModuleList([ResidualAttentionBlock(width, heads, act, causal)
                                        for _ in range(layers)])


class CLIPTextTransformer(nn.Module):
    """ViT-H-14 text config by default: width 1024, 16 heads, 24 layers,
    vocab 49408."""

    def __init__(self, vocab_size: int = 49408, width: int = 1024, heads: int = 16,
                 layers: int = 24, penultimate: bool = True, act: str = "gelu",
                 context_length: int = CONTEXT_LENGTH):
        super().__init__()
        self.layers = layers
        self.penultimate = penultimate
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = _Transformer(width, heads, layers, act)
        self.ln_final = nn.LayerNorm(width, eps=1e-5)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, context_length) int -> (B, context_length, width)."""
        x = self.token_embedding(tokens) + self.positional_embedding
        n_blocks = self.layers - 1 if self.penultimate else self.layers
        for blk in self.transformer.resblocks[:n_blocks]:
            x = blk(x)
        return self.ln_final(x)


class FrozenOpenCLIPEmbedder(nn.Module):
    """Tokenizer + text tower (config-compatible with the reference embedder,
    configs.INFERENCE_NUSCENES ``conditioner_config``)."""

    def __init__(self, arch="ViT-H-14", version=None, device=None, max_length=CONTEXT_LENGTH,
                 freeze=True, layer="penultimate", bpe_path=None, width=1024, heads=16,
                 layers=24, vocab_size=49408, act="gelu"):
        super().__init__()
        if layer not in ("last", "penultimate"):
            raise ValueError(f"unsupported layer {layer!r}")
        self.max_length = max_length
        self.model = CLIPTextTransformer(vocab_size, width, heads, layers,
                                         penultimate=layer == "penultimate", act=act,
                                         context_length=max_length)
        self.tokenizer = SimpleTokenizer(bpe_path)

    def tokens(self, texts) -> torch.Tensor:
        device = self.model.positional_embedding.device
        return torch.as_tensor(self.tokenizer(texts, self.max_length), dtype=torch.long,
                               device=device)

    def forward(self, texts) -> torch.Tensor:
        return self.model(self.tokens(texts)).float()


class FrozenCLIPEmbedder(FrozenOpenCLIPEmbedder):
    """OpenAI's CLIP-L text encoder (reference modules.py:385; JAX
    clip.py:165-180): width 768, 12 heads, 12 layers, quick_gelu, the last
    layer unless ``layer`` is 'penultimate' (any other choice reads as
    'last', as in the JAX package)."""

    def __init__(self, version=None, device=None, max_length=CONTEXT_LENGTH, freeze=True,
                 layer="last", layer_idx=None, bpe_path=None):
        super().__init__(max_length=max_length, freeze=freeze,
                         layer="penultimate" if layer == "penultimate" else "last",
                         bpe_path=bpe_path, width=768, heads=12, layers=12,
                         act="quick_gelu")


class CLIPVisionTransformer(nn.Module):
    """open_clip's ViT image tower (ViT-H/14 by default; JAX
    clip.py:183-227). Input (B, image_size, image_size, 3), preprocessed."""

    def __init__(self, image_size: int = 224, patch_size: int = 14, width: int = 1280,
                 heads: int = 16, layers: int = 32, output_dim: int = 1024, act: str = "gelu"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        n_tok = (image_size // patch_size) ** 2 + 1
        self.positional_embedding = nn.Parameter(torch.empty(n_tok, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.transformer = _Transformer(width, heads, layers, act, causal=False)
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    def forward(self, x: torch.Tensor, output_tokens: bool = False):
        b = x.shape[0]
        h = self.conv1(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)   # (B, P, width)
        cls = self.class_embedding.to(h.dtype).expand(b, 1, -1)
        h = self.ln_pre(torch.cat([cls, h], dim=1) + self.positional_embedding)
        for blk in self.transformer.resblocks:
            h = blk(h)
        h = self.ln_post(h)
        pooled = h[:, 0] @ self.proj
        return (pooled, h[:, 1:]) if output_tokens else pooled


class _Visual(nn.Module):
    """Holds the tower under open_clip's ``visual`` name."""

    def __init__(self, visual: CLIPVisionTransformer):
        super().__init__()
        self.visual = visual


class FrozenOpenCLIPImageEmbedder(nn.Module):
    """CLIP image embedder (reference modules.py:635-720; JAX
    clip.py:230-295): x (B, H, W, 3) in [-1, 1] is resized to 224 x 224 and
    normalised, and its pooled embedding comes back, with a sequence axis
    where ``unsqueeze_dim``, repeated ``max_length`` times where
    ``repeat_to_max_len``. As in the JAX package, ``output_tokens``,
    ``antialias`` and ``num_image_crops`` are accepted and change nothing."""

    OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
    OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)

    def __init__(self, arch="ViT-H-14", version=None, device=None, max_length=CONTEXT_LENGTH,
                 freeze=True, antialias=True, ucg_rate=0.0, unsqueeze_dim=False,
                 repeat_to_max_len=False, num_image_crops=0, output_tokens=False,
                 width=1280, heads=16, layers=32, output_dim=1024):
        super().__init__()
        self.model = _Visual(CLIPVisionTransformer(width=width, heads=heads, layers=layers,
                                                   output_dim=output_dim))
        self.max_length = max_length
        self.unsqueeze_dim = unsqueeze_dim
        self.repeat_to_max_len = repeat_to_max_len
        self.ucg_rate = ucg_rate

    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [-1, 1] -> CLIP-normalised (B, 224, 224, 3)."""
        x = resize(x.float(), (x.shape[0], 224, 224, 3), "bicubic")
        x = (x + 1.0) / 2.0
        mean = torch.tensor(self.OPENAI_MEAN, device=x.device)
        std = torch.tensor(self.OPENAI_STD, device=x.device)
        return (x - mean) / std

    def forward(self, x) -> torch.Tensor:
        device = self.model.visual.proj.device
        emb = self.model.visual(self.preprocess(torch.as_tensor(x, device=device)))
        if self.unsqueeze_dim:
            emb = emb[:, None, :]
        if self.repeat_to_max_len:
            e = emb[:, None, :] if emb.ndim == 2 else emb
            return e.repeat(1, self.max_length, 1)
        return emb
