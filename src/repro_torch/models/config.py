"""Model configuration for the architecture zoo, port of
``repro.models.config`` (the port keeps its own copy).

One dataclass covers all seven families (dense / moe / ssm / hybrid /
hybrid_moe / audio enc-dec / vlm); family-specific fields are zero/None
when unused, and every default leaves the other families as they were.

The ``hybrid_moe`` family (granite-4.0-h) interleaves two kinds of layer
in a published pattern: layer ``i`` is an attention layer where ``i %
attn_period == attn_offset`` and a Mamba-2 layer otherwise, each followed
by a routed-expert feed-forward with a shared expert beside it.
``reduced()`` produces the CPU-smoke-test variant required per architecture
(≤2 layers, d_model ≤ 512, ≤4 experts) while preserving the family wiring.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str     # dense | moe | ssm | hybrid | hybrid_moe | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    source: str = ""            # citation (paper/model card)

    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    mrope: bool = False                      # qwen2-vl M-RoPE
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    sliding_window: int = 0                  # 0 = full attention
    nope: bool = False                       # no positional embedding
    attention_multiplier: float = 0.0        # score scale; 0 -> 1/sqrt(hd)

    # MoE
    num_experts: int = 0                     # the experts held here
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_experts: int = 0      # the router's width; 0 -> num_experts
    expert_offset: int = 0       # the first held expert's router index
    shared_d_ff: int = 0         # 0 -> num_shared_experts * moe_d_ff
    moe_dropless: bool = False   # every choice of a held expert computed
    expert_units: bool = False               # beyond-paper: expert-level FedLDF units

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    ssm_expand: int = 2

    # layer pattern (hybrid_moe): attention where i % period == offset
    attn_period: int = 0
    attn_offset: int = 0

    # encoder-decoder (audio)
    encoder_layers: int = 0                  # >0 => enc-dec
    frontend_dim: int = 0                    # stub embedding dim (audio/vlm)

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # muP multipliers (granite): embedding, each residual branch, logits
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0              # the logits are divided by it

    # performance knobs (§Perf hillclimb levers)
    remat_blocks: bool = False   # checkpoint each block in bwd (training)
    attn_chunk: int = 1024       # flash KV-chunk length (carry-rewrite trade)
    attn_probs_bf16: bool = False  # store attention probabilities in bf16

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(1, self.num_heads)  # 0 heads: attn-free

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def router_width(self) -> int:
        return self.router_experts or self.num_experts

    @property
    def shared_width(self) -> int:
        return self.shared_d_ff or self.num_shared_experts * self.moe_d_ff

    def is_attention_layer(self, layer: int) -> bool:
        """Whether layer ``layer`` of a patterned stack attends (otherwise
        it runs the SSD)."""
        return layer % self.attn_period == self.attn_offset

    @property
    def num_attention_layers(self) -> int:
        """The layers a patterned stack holds under its attention key (0
        without a pattern)."""
        if not self.attn_period:
            return 0
        return sum(map(self.is_attention_layer, range(self.num_layers)))

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Approximate parameter count N (for 6·N·D model-FLOPs)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        qdim = self.num_heads * self.hd
        kvdim = self.num_kv_heads * self.hd
        attn = d * qdim + 2 * d * kvdim + qdim * d                # q,k,v,o
        di, n, h = self.ssm_d_inner, self.ssm_state, self.ssm_heads
        ssm = d * (2 * di + 2 * n + h) + di * d                   # in/out proj
        per_layer = 0
        if self.family in ("dense", "moe", "hybrid", "vlm", "audio"):
            per_layer += attn
        if self.family == "hybrid" or self.family == "ssm":
            per_layer += ssm
        if self.num_experts > 0:
            per_layer += (self.num_experts * 3 * d * self.moe_d_ff
                          + 3 * d * self.shared_width
                          + d * self.router_width)
        elif f > 0:
            per_layer += 3 * d * f                                # SwiGLU
        total = self.num_layers * per_layer
        if self.family == "hybrid_moe":
            n_attn = self.num_attention_layers
            total += n_attn * attn + (self.num_layers - n_attn) * ssm
        if self.is_encdec:
            enc_layer = (d * self.num_heads * self.hd * 2
                         + 2 * d * self.num_kv_heads * self.hd + 3 * d * f)
            total += self.encoder_layers * enc_layer
            total += self.num_layers * (2 * d * self.num_kv_heads * self.hd
                                        + 2 * d * self.num_heads * self.hd)
        total += v * d * (1 if self.tie_embeddings else 2)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top-k routed)."""
        if self.num_experts == 0:
            return self.param_count()
        d = self.d_model
        dense_like = self.param_count() - self.num_layers * (
            self.num_experts * 3 * d * self.moe_d_ff)
        active_moe = self.num_layers * self.moe_top_k * 3 * d * self.moe_d_ff
        return int(dense_like + active_moe)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """CPU smoke-test variant: same family wiring, tiny dims."""
        nh = min(self.num_heads, 4)
        nkv = max(1, min(self.num_kv_heads, nh))
        while nh % nkv:
            nkv -= 1
        if self.mrope:
            # rescale sections to the reduced head_dim (32 -> half = 16)
            mrope_sections = (4, 6, 6)
        else:
            mrope_sections = self.mrope_sections
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=2,
            encoder_layers=2 if self.is_encdec else 0,
            d_model=128,
            num_heads=nh,
            num_kv_heads=nkv,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            mrope_sections=mrope_sections,
            num_experts=min(self.num_experts, 4),
            num_shared_experts=min(self.num_shared_experts, 1),
            moe_top_k=min(self.moe_top_k, 2),
            moe_d_ff=64 if self.num_experts else 0,
            router_experts=min(self.router_experts, 8),
            expert_offset=0,
            shared_d_ff=128 if self.shared_d_ff else 0,
            # two layers keep both kinds of a pattern
            attn_period=min(self.attn_period, 2),
            attn_offset=self.attn_offset % 2 if self.attn_period else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32,
            ssm_chunk=16,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            frontend_dim=128 if self.frontend_dim else 0,
        )


# The port's own fields, which ``repro.models.config.ModelConfig`` lacks:
# granite-4.0-h's options. At their defaults a config is the reference's.
PORT_FIELDS = ("nope", "attention_multiplier", "router_experts",
               "expert_offset", "shared_d_ff", "moe_dropless", "attn_period",
               "attn_offset", "norm_eps", "embedding_multiplier",
               "residual_multiplier", "logits_scaling")


def reference_fields(cfg: ModelConfig) -> dict:
    """``dataclasses.asdict(cfg)`` without :data:`PORT_FIELDS`: the fields
    the reference's config has, to compare with it. Raises where a port
    field is not at its default (such a config has no reference)."""
    out = dataclasses.asdict(cfg)
    for name in PORT_FIELDS:
        default = ModelConfig.__dataclass_fields__[name].default
        if out.pop(name) != default:
            raise ValueError(f"{cfg.name}: {name} is not at its default, "
                             "so the reference has no such config")
    return out


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]
