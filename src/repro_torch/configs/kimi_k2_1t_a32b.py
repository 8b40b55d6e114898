"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) vocab=163840.

Trillion-parameter MoE: 384 experts, top-8, d_ff=2048/expert, 1 shared
expert, first layer dense (d_ff=18432). Per the assignment table this uses
plain GQA attention (head_dim=128), unlike deepseek-v3's MLA.
[arXiv:2501.kimi2; unverified — paper-table entry]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, vocab=163840,
        n_heads=64, n_kv_heads=8, head_dim=128,
        ffn_act="silu",
        n_experts=384, n_experts_per_tok=8, n_shared_experts=1,
        moe_d_ff=2048, first_k_dense=1, dense_d_ff=18432,
        rope_theta=50000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-smoke", family="moe",
        n_layers=3, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, head_dim=16,
        ffn_act="silu",
        n_experts=8, n_experts_per_tok=2, n_shared_experts=1,
        moe_d_ff=32, first_k_dense=1, dense_d_ff=128,
        dtype="float32", attn_chunk_q=16,
    )


register("kimi-k2-1t-a32b", full, smoke)
