"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.

Per-head RMS qk-norm, SwiGLU, head_dim=128. [hf:Qwen/Qwen3-14B; hf]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b", family="dense",
        n_layers=40, d_model=5120, vocab=151936,
        n_heads=40, n_kv_heads=8, head_dim=128, qk_norm=True,
        d_ff=17408, ffn_act="silu",
        rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b-smoke", family="dense",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=True,
        d_ff=128, ffn_act="silu",
        dtype="float32", attn_chunk_q=16,
    )


register("qwen3-14b", full, smoke)
