"""Model/run configuration schema for the architecture zoo.

A copy of the JAX package's ``configs/base.py`` (plain dataclasses, so
the two packages describe a model by equal values).  One frozen dataclass
describes every assigned architecture (dense, MoE, SSM, hybrid, enc-dec,
VLM backbone).  Architectures are registered by id
(``repro_torch.configs.registry``) and selected with ``--arch <id>`` by
every launcher.  ``reduced()`` derives the CPU-smoke-test configuration —
same family and block pattern, tiny dimensions.  The port's model runs
every block kind but ``mamba``, and no MoE yet
(:mod:`repro_torch.models.model`).
"""

from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int | None = None          # default d_model // n_heads
    # --- block layout -------------------------------------------------
    # One "period" of blocks, scanned n_layers/len(pattern) times.
    # Entries: "attn" | "mamba" | "mlstm" | "slstm".
    block_pattern: tuple[str, ...] = ("attn",)
    # --- MoE ------------------------------------------------------------
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1           # MoE replaces the MLP every k-th block
    capacity_factor: float = 1.25
    # --- attention ------------------------------------------------------
    rope: str = "standard"       # standard | rope2d | mrope | none
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    attn_chunk: int = 1024       # online-softmax KV block (0 = dense)
    kv_cache_dtype: str = "bf16"  # bf16 | int8 (quantised decode cache)
    # --- mlp / norm -------------------------------------------------
    mlp_act: str = "swiglu"      # swiglu | gelu | relu2
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    tie_embeddings: bool = False
    # --- ssm ------------------------------------------------------------
    d_state: int = 16
    d_conv: int = 4
    ssm_expand: int = 2
    # --- enc-dec / frontends ---------------------------------------
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: str | None = None  # None | "audio" | "vision"
    # --- the paper's technique (first-class switch) -----------------
    gather_impl: str = "take"    # take | onehot | auto
    # --- numerics ---------------------------------------------------
    param_dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_periods(self) -> int:
        assert self.n_layers % self.period == 0, \
            f"{self.name}: n_layers={self.n_layers} % period={self.period}"
        return self.n_layers // self.period

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def moe_at(self, block_idx: int) -> bool:
        return self.moe and (block_idx % self.moe_every == self.moe_every - 1)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, hd = self.d_model, self.hd
        n = self.vocab * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            kind = self.block_pattern[i % self.period]
            if kind == "attn":
                n += d * (self.n_heads * hd) * 2            # wq, wo
                n += d * (self.n_kv_heads * hd) * 2         # wk, wv
            elif kind == "mamba":
                di = self.d_inner
                n += d * 2 * di + di * d                    # in/out proj
                n += di * (self.d_state * 2 + 2) + di * self.d_conv
            elif kind in ("mlstm", "slstm"):
                di = self.d_inner
                n += d * di * 4 + di * d
            if self.moe_at(i):
                n += d * self.n_experts                     # router
                n += self.n_experts * 3 * d * self.moe_d_ff
            elif self.d_ff:
                n += 3 * d * self.d_ff if self.mlp_act == "swiglu" \
                    else 2 * d * self.d_ff
            n += 2 * d                                      # norms
        if self.enc_dec:
            # encoder self-attn + mlp + decoder cross-attn, rough
            n += self.n_enc_layers * (4 * d * self.n_heads * hd
                                      + 2 * d * self.d_ff + 2 * d)
            n += self.n_layers * 4 * d * self.n_heads * hd  # cross attn
        return n

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        moe_blocks = sum(self.moe_at(i) for i in range(self.n_layers))
        expert_params = moe_blocks * self.n_experts * 3 * self.d_model \
            * self.moe_d_ff
        active = moe_blocks * self.top_k * 3 * self.d_model * self.moe_d_ff
        return full - expert_params + active

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2 * len(self.block_pattern),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 4) if self.moe else 0,
            top_k=min(self.top_k, 2) if self.moe else 0,
            moe_d_ff=32 if self.moe else 0,
            d_state=8,
            ssm_expand=2,
            attn_chunk=0,
            n_enc_layers=2 if self.enc_dec else 0,
            param_dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
