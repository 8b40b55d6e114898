"""mamba2-370m [ssm] — 48L d_model=1024 (attention-free) vocab=50280, ssm_state=128.

SSD (state-space duality) chunked scan; d_inner = 2×1024 = 2048, head_dim 64
⇒ 32 SSM heads. Tied embeddings. Runs long_500k (O(1)/token decode).
[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        n_layers=48, d_model=1024, vocab=50280,
        ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
        ssm_chunk=256, ssm_n_groups=1,
        tie_embeddings=True, pos_embed="none",
        # 50280 is not divisible by the 16-way model axis; pad the embedding
        # rows to 50288 (= 16·3143) — the padded logits are masked in the loss.
        vocab_pad_multiple=16,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=64, vocab=256,
        ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=32,
        ssm_chunk=16, ssm_n_groups=1,
        tie_embeddings=True, pos_embed="none",
        dtype="float32",
    )


register("mamba2-370m", full, smoke)
