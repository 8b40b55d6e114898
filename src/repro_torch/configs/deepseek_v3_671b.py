"""deepseek-v3-671b [moe] — 61L d_model=7168 128H MLA vocab=129280.

MLA (q_lora=1536, kv_lora=512, rope=64 + nope=128, v=128); 1 shared + 256
routed experts top-8 (d_ff=2048/expert); first 3 layers dense (d_ff=18432);
MTP head depth 1. Decode caches the compressed (c_kv, k_rope) stream only.
[arXiv:2412.19437; hf]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, vocab=129280,
        n_heads=128,
        use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        ffn_act="silu",
        n_experts=256, n_experts_per_tok=8, n_shared_experts=1,
        moe_d_ff=2048, first_k_dense=3, dense_d_ff=18432,
        mtp_depth=1,
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-smoke", family="moe",
        n_layers=3, d_model=64, vocab=256,
        n_heads=4,
        use_mla=True, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        ffn_act="silu",
        n_experts=8, n_experts_per_tok=2, n_shared_experts=1,
        moe_d_ff=32, first_k_dense=1, dense_d_ff=128,
        mtp_depth=1,
        dtype="float32", attn_chunk_q=16,
    )


register("deepseek-v3-671b", full, smoke)
