"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240, ssm_state=64.

Mamba2 backbone with one SHARED attention+FFN block applied after every 6th
mamba layer (shared weights; the per-invocation LoRA deltas of the released
model are dropped — simplification noted in DESIGN.md §4). Sub-quadratic ⇒
runs long_500k. [arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, vocab=32000,
        n_heads=32, n_kv_heads=32, head_dim=80,
        d_ff=10240, ffn_act="gelu",
        ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
        ssm_chunk=128, ssm_n_groups=1,
        hybrid_attn_every=6,
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=4, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, ffn_act="gelu",
        ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=32,
        ssm_chunk=16, ssm_n_groups=1,
        hybrid_attn_every=2,
        dtype="float32", attn_chunk_q=16,
    )


register("zamba2-2.7b", full, smoke)
