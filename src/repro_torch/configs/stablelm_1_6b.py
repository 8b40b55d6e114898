"""stablelm-1.6b [dense] — 24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352.

LayerNorm, partial rotary (25% of head_dim), SwiGLU, tied embeddings.
[hf:stabilityai/stablelm-2-1_6b; unverified]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", family="dense",
        n_layers=24, d_model=2048, vocab=100352,
        n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=5632, ffn_act="silu",
        norm="layernorm", norm_eps=1e-5,
        rotary_pct=0.25, rope_theta=10000.0,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke", family="dense",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, ffn_act="silu",
        norm="layernorm", norm_eps=1e-5, rotary_pct=0.25,
        tie_embeddings=True,
        dtype="float32", attn_chunk_q=16,
    )


register("stablelm-1.6b", full, smoke)
