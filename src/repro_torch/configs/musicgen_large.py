"""musicgen-large [audio] — 48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048.

Decoder-only over EnCodec tokens. The codec frontend is a STUB:
``input_specs()`` provides precomputed frame embeddings (the sum of the 4
delayed codebook embeddings); sinusoidal positions; ungated GELU FFN;
LayerNorm. Text cross-attention conditioning is omitted (stub prefix) —
noted in DESIGN.md §4. [arXiv:2306.05284; hf]
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="dense", modality="audio",
        n_layers=48, d_model=2048, vocab=2048,
        n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, ffn_act="gelu_mlp",
        norm="layernorm", norm_eps=1e-5,
        pos_embed="sinusoidal",
        inputs_are_embeds=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", family="dense", modality="audio",
        n_layers=2, d_model=64, vocab=64,
        n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, ffn_act="gelu_mlp",
        norm="layernorm", norm_eps=1e-5,
        pos_embed="sinusoidal", inputs_are_embeds=True,
        dtype="float32", attn_chunk_q=16,
    )


register("musicgen-large", full, smoke)
