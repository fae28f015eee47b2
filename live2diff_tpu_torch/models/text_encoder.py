"""CLIP ViT-L/14 text encoder (SD-1.5's conditioning model), in torch.

Port of ``live2diff_tpu/models/text_encoder.py``, with clip_skip: the
hidden state ``clip_skip`` layers before the end, through the final
LayerNorm. Modules are named after the HF ``CLIPTextModel`` keys
(``text_model.embeddings.token_embedding``, ``text_model.encoder.layers.N.
self_attn.q_proj``, ``text_model.final_layer_norm``, ...), so a
``text_encoder/model.safetensors`` loads by name. LayerNorms and the
softmax run in fp32 whatever the compute dtype; the attention takes the
causal ``-inf`` bias through ``ops.attention.dot_product_attention``'s
dense path, with no kernel, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in fp32, returned in fp32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.heads = cfg.num_heads
        h = cfg.hidden_size
        self.q_proj, self.k_proj = nn.Linear(h, h), nn.Linear(h, h)
        self.v_proj, self.out_proj = nn.Linear(h, h), nn.Linear(h, h)

    def forward(self, x: torch.Tensor, causal_bias: torch.Tensor) -> torch.Tensor:
        def split(t):
            return t.reshape(*t.shape[:-1], self.heads, -1)

        out = dot_product_attention(split(self.q_proj(x)), split(self.k_proj(x)),
                                    split(self.v_proj(x)), bias=causal_bias)
        return self.out_proj(out.reshape(x.shape))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm32(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = LayerNorm32(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor, causal_bias: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x).to(x.dtype), causal_bias)
        return x + self.mlp(self.layer_norm2(x).to(x.dtype))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Token plus position embeddings."""
        return (self.token_embedding(input_ids)
                + self.position_embedding.weight[None, :input_ids.shape[1]])


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = LayerNorm32(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextModelWithFinalNorm(nn.Module):
    """The CLIP text transformer; ``forward`` encodes with clip_skip."""

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)

    def forward(self, input_ids: torch.Tensor, clip_skip: int = 0) -> torch.Tensor:
        """``[B, S]`` token ids -> the prompt embedding ``[B, S, hidden]`` in
        the weights' dtype.

        clip_skip=0: the last layer, then the final LayerNorm.
        clip_skip=k>=1: hidden_states[-(k+1)] (hidden_states[0] being the
        embeddings), then the final LayerNorm."""
        tm = self.text_model
        s = input_ids.shape[1]
        x = tm.embeddings(input_ids)
        causal = torch.triu(torch.full((s, s), float("-inf"), device=x.device), 1)[None, None]
        # hidden_states has num_layers + 1 entries; run only the layers needed
        n_layers = len(tm.encoder.layers) - (clip_skip if clip_skip >= 1 else 0)
        for layer in tm.encoder.layers[:n_layers]:
            x = layer(x, causal)
        return tm.final_layer_norm(x).to(x.dtype)
