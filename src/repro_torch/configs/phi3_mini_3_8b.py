"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.

RoPE + SwiGLU, MHA (kv == heads), head_dim=96. [arXiv:2404.14219; unverified]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, vocab=32064,
        n_heads=32, n_kv_heads=32, head_dim=96,
        d_ff=8192, ffn_act="silu",
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-smoke", family="dense",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, ffn_act="silu",
        dtype="float32", attn_chunk_q=16,
    )


register("phi3-mini-3.8b", full, smoke)
