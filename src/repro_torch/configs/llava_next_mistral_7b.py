"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.

Mistral-7B backbone; the anyres vision tower is a STUB — ``input_specs()``
feeds 576 precomputed patch embeddings (one base 24×24 CLIP grid) which are
projected and prepended to the token embeddings (DESIGN.md §4).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

N_PATCHES = 576


def full() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b", family="dense", modality="vlm",
        n_layers=32, d_model=4096, vocab=32000,
        n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, ffn_act="silu",
        rope_theta=1_000_000.0,
        n_prefix_embeds=N_PATCHES,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llava-next-smoke", family="dense", modality="vlm",
        n_layers=2, d_model=64, vocab=256,
        n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, ffn_act="silu",
        n_prefix_embeds=8,
        dtype="float32", attn_chunk_q=16,
    )


register("llava-next-mistral-7b", full, smoke)
