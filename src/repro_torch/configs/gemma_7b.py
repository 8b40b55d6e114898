"""gemma-7b [dense] — 28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000.

GeGLU, head_dim=256, tied embeddings scaled by sqrt(d_model), zero-centered
RMSNorm (1+scale). [arXiv:2403.08295; hf]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b", family="dense",
        n_layers=28, d_model=3072, vocab=256000,
        n_heads=16, n_kv_heads=16, head_dim=256,
        d_ff=24576, ffn_act="gelu",
        rope_theta=10000.0,
        tie_embeddings=True, embed_scale=True, zero_centered_norm=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b-smoke", family="dense",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=128, ffn_act="gelu",
        tie_embeddings=True, embed_scale=True, zero_centered_norm=True,
        dtype="float32", attn_chunk_q=16,
    )


register("gemma-7b", full, smoke)
