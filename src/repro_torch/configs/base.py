"""Configuration dataclasses for models and the dry-run's shape cells
(the port's copy of ``repro/configs/base.py``).

Every ported architecture has one module in this package exporting
``CONFIG`` (the exact published configuration) and ``smoke_config()`` (a
reduced same-family configuration for CPU tests). The port carries every
configuration of the JAX package: dense attention stacks, global or local
and global, the vision-embedding backbone, the Mamba-2 SSD stack, the
RG-LRU + local attention hybrid, the MoE stacks and the encoder-decoder.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Layer kinds used in the per-period layer pattern.
# ---------------------------------------------------------------------------
GLOBAL_ATTN = "global_attn"   # full causal attention
LOCAL_ATTN = "local_attn"     # sliding-window attention
RGLRU = "rglru"               # RG-LRU recurrent block (recurrentgemma)
SSD = "ssd"                   # Mamba-2 state-space duality block


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    # llama4-style always-on shared expert (0 = none)
    d_ff_shared: int = 0
    # which layers are MoE: every `interleave`-th layer (1 = all layers)
    interleave: int = 1
    router_jitter: float = 0.0
    load_balance_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class PortMoEConfig(MoEConfig):
    """An ``MoEConfig`` of a configuration the port has and the JAX
    package has not (``PORT_ONLY_IDS``). ``norm_topk_prob``: whether the
    top-k routing weights are divided by their sum (True, as every routed
    configuration of the JAX package routes) or left as the softmax's
    probabilities over all experts (OLMoE-1B-7B-0924's
    ``norm_topk_prob: false``). ``models.moe`` reads it with its default
    from any ``MoEConfig``."""
    norm_topk_prob: bool = True


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    headdim: int = 64          # mamba2 P (head dim)
    chunk_size: int = 256      # SSD chunk length
    conv_width: int = 4
    ngroups: int = 1


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0          # 0 → d_model
    conv_width: int = 4
    expand: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 → d_model // n_heads
    # Layer pattern repeated across depth, e.g. 5×local:1×global for gemma3.
    # Length of the tuple is the "period"; remainder layers (n_layers % period)
    # are taken from the prefix of the pattern and unrolled.
    layer_pattern: Tuple[str, ...] = (GLOBAL_ATTN,)
    window: int = 1024          # sliding window for LOCAL_ATTN layers
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # gating MLP (SwiGLU) unless False → GELU MLP (whisper)
    gated_mlp: bool = True
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # encoder-decoder (whisper): encoder layers use bidirectional attention,
    # decoder layers add cross attention.
    enc_dec: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500     # precomputed frame positions (audio stub)
    # modality frontend stub: 'none' | 'vision' | 'audio'
    frontend: str = "none"
    frontend_tokens: int = 0    # e.g. 256 patch embeddings for vlm
    max_seq: int = 131072
    # Which shapes this arch supports. long_500k only for sub-quadratic stacks.
    supports_long_context: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return all(k in (SSD, RGLRU) for k in self.layer_pattern)

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + norms), as the
        JAX package counts it."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = 2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
        mlp_mult = 3 if self.gated_mlp else 2
        mlp = mlp_mult * d * self.d_ff
        per_layer = {GLOBAL_ATTN: attn + mlp, LOCAL_ATTN: attn + mlp}
        if self.ssm is not None:
            di = self.ssm.expand * d
            nh = di // self.ssm.headdim
            in_proj = d * (2 * di + 2 * self.ssm.ngroups * self.ssm.d_state
                           + nh)
            per_layer[SSD] = in_proj + di * d + di * self.ssm.conv_width
        if self.rglru is not None:
            w = self.rglru.lru_width or d
            per_layer[RGLRU] = 2 * d * w + w * d + 3 * w + mlp
        if self.moe is not None:
            moe_mlp = (self.moe.num_experts * mlp_mult * d
                       * self.moe.d_ff_expert
                       + mlp_mult * d * self.moe.d_ff_shared
                       + d * self.moe.num_experts)
        total = emb
        for i in range(self.n_layers):
            kind = self.layer_pattern[i % len(self.layer_pattern)]
            blk = per_layer[kind]
            if self.moe is not None and kind in (GLOBAL_ATTN, LOCAL_ATTN) \
                    and i % self.moe.interleave == self.moe.interleave - 1:
                blk = blk - mlp + moe_mlp
            total += blk + 2 * d  # norms
        if self.enc_dec:
            enc_attn = attn + mlp
            total += self.n_encoder_layers * (enc_attn + 2 * d)
            total += self.n_layers * (attn + d)  # decoder cross-attn + norm
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top_k + shared)."""
        if self.moe is None:
            return self.param_count()
        base = dataclasses.replace(self, moe=None).param_count()
        d = self.d_model
        mlp_mult = 3 if self.gated_mlp else 2
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if i % self.moe.interleave
                           == self.moe.interleave - 1)
        delta = n_moe_layers * mlp_mult * d * (
            self.moe.top_k * self.moe.d_ff_expert + self.moe.d_ff_shared
            - self.d_ff)
        return int(base + delta)


@dataclasses.dataclass(frozen=True)
class PortModelConfig(ModelConfig):
    """A ``ModelConfig`` of a configuration the port has and the JAX
    package has not (``PORT_ONLY_IDS``): the ten shared configurations
    stay field for field the JAX package's. ``qk_norm``: an RMS norm over
    each position's whole projected query width (H·d) and key width
    (KH·d), with weights of their own, after the projections and before
    RoPE (OLMoE's). ``models.transformer`` reads it with its default from
    any ``ModelConfig``."""
    qk_norm: bool = False


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # 'train' | 'prefill' | 'decode'


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


ARCH_IDS = (
    "recurrentgemma_9b",
    "gemma3_27b",
    "phi4_mini_3_8b",
    "codeqwen15_7b",
    "yi_9b",
    "pixtral_12b",
    "whisper_large_v3",
    "mamba2_370m",
    "llama4_scout_17b_a16e",
    "olmoe_1b_7b",
)

# configurations of the port alone: ``get_config`` resolves them, and the
# dry-run's cells and the parity tests (over ``ARCH_IDS``) leave them out
PORT_ONLY_IDS = (
    "olmoe_1b_7b_0924",
)

# CLI ids use dashes (``--arch recurrentgemma-9b``); module names use
# underscores.
_ALIASES = {
    "phi4_mini_38b": "phi4_mini_3_8b",
    "codeqwen1_5_7b": "codeqwen15_7b",
    "llama4_scout_17b_16e": "llama4_scout_17b_a16e",
}


def canon(arch_id: str) -> str:
    s = arch_id.replace("-", "_").replace(".", "_")
    return _ALIASES.get(s, s)


# the architectures whose every layer kind the port runs: all of them
PORTED_ARCH_IDS = ARCH_IDS


def _module(arch_id: str):
    name = canon(arch_id)
    if name not in ARCH_IDS + PORT_ONLY_IDS:
        raise ValueError(f"unknown architecture {arch_id!r}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """The shape cells defined for an architecture (33 over the pool)."""
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.supports_long_context:
        shapes.append(LONG_500K)
    return tuple(shapes)


def all_cells() -> Sequence[Tuple[str, ShapeConfig]]:
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            cells.append((arch, shape))
    return cells
