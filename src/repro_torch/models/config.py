"""Model configuration — one dataclass covers all 10 assigned families.

The port's own copy of the JAX package's ``models/config.py``, field for
field (the port imports nothing of that package); the tests hold every
config and ``n_params`` equal to it.  ``unroll_layers`` (the
reference's cost-probe compiles) is carried for the configs' sake; the
port reads every other field.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str            # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0

    # MLA (deepseek-v2)
    mla: bool = False
    kv_lora: int = 0
    q_lora: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    mla_absorb: bool = True   # absorbed decode (W_uk/W_uv folded); False
    #                           = naive per-head expansion (perf baseline)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssd_chunk: int = 128   # SSD intra-chunk length Q (the (b,nc,h,Q,Q)
    #                        decay tensor is the working-set whale)

    # hybrid (zamba2): one shared attention+MLP block applied periodically
    attn_every: int = 0

    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_frames: int = 1500
    cross_attn: bool = False

    # sparse attention (DDM planner; sparse/)
    attn_pattern: str = "full"    # full | ddm_window
    window: int = 0               # kv window size (tokens), ddm_window
    n_sink_blocks: int = 1        # global "attention sink" blocks
    block_q: int = 128
    block_kv: int = 128
    window_gather_decode: bool = False  # decode reads only the DDM
    #   window + sink from the cache (dynamic-slice gather) instead of
    #   masking the full context — §Perf beyond-paper optimization

    # numerics / structure
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True
    q_chunk: int = 128          # attention query-chunk (flash outer loop)
    ce_chunk: int = 512         # cross-entropy sequence chunk (train)
    grad_accum: int = 1         # microbatches per step (activation mem ÷ k)
    unroll_layers: bool = False  # unroll layer loops (cost-probe compiles)

    # -- derived -----------------------------------------------------------
    @property
    def d_inner(self) -> int:        # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or (self.d_inner // self.ssm_head_dim)

    @property
    def group_size(self) -> int:     # GQA group
        return self.n_heads // max(self.n_kv_heads, 1)

    def n_params(self) -> int:
        """Analytic parameter count (embedding included once)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "audio", "hybrid"):
            if self.mla:
                attn = (d * (self.kv_lora + self.rope_head_dim)
                        + self.kv_lora * self.n_heads
                        * (self.nope_head_dim + self.v_head_dim))
                if self.q_lora:
                    attn += (d * self.q_lora + self.q_lora * self.n_heads
                             * (self.nope_head_dim + self.rope_head_dim))
                else:
                    attn += d * self.n_heads * (self.nope_head_dim
                                                + self.rope_head_dim)
                attn += self.n_heads * self.v_head_dim * d
            else:
                attn = d * self.d_head * (self.n_heads + 2 * self.n_kv_heads)
                attn += self.n_heads * self.d_head * d
            mlp = 3 * d * f
            if self.family == "moe":
                moe_mlp = 3 * d * self.moe_d_ff
                shared = self.n_shared_experts * moe_mlp
                router = d * self.n_experts
                dense_l = self.first_dense_layers
                per_layer_moe = attn + self.n_experts * moe_mlp + shared \
                    + router + 2 * d
                per_layer_dense = attn + mlp + 2 * d
                return (emb + dense_l * per_layer_dense
                        + (self.n_layers - dense_l) * per_layer_moe + d)
            per_layer = attn + mlp + 2 * d
        if self.family == "ssm":
            di, ns, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
            conv_ch = di + 2 * ns
            per_layer = (d * (2 * di + 2 * ns + nh)       # in_proj
                         + conv_ch * self.conv_width      # conv
                         + nh * 2 + di                    # A_log, D, norm
                         + di * d + d)                    # out_proj + norm
            return emb + self.n_layers * per_layer + d
        if self.family == "hybrid":
            di, ns, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
            conv_ch = di + 2 * ns
            mamba_l = (d * (2 * di + 2 * ns + nh) + conv_ch * self.conv_width
                       + nh * 2 + di + di * d + d)
            attn_shared = per_layer  # one shared attn+mlp block
            return emb + self.n_layers * mamba_l + attn_shared + d
        if self.family == "audio":
            enc = self.enc_layers * per_layer
            dec_cross = self.n_layers * (d * self.d_head
                                         * (self.n_heads + 2 * self.n_kv_heads)
                                         + self.n_heads * self.d_head * d + d)
            return emb + enc + self.n_layers * per_layer + dec_cross + d
        return emb + self.n_layers * per_layer + d
