"""Model/arch configuration schema + the assigned-architecture registry.

Port of ``repro.configs.base``: the port keeps its own copy, since it
imports nothing of the JAX package. Every assigned architecture is a
``ModelConfig`` constructed by a function in its own ``configs/<id>.py``
file (exact published hyper-parameters), plus a ``smoke()`` variant — same
family/wiring, tiny widths — used by the CPU tests. The port runs the dense
family's full configs on the card (``chip_smoke.py`` phase 13 allocates
``stablelm-1.6b`` at full width).

``ShapeSpec`` captures the assigned input-shape grid (train_4k / prefill_32k /
decode_32k / long_500k) and which step each shape lowers (train vs serve).
"""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "dense" | "moe" | "ssm" | "hybrid"
    n_layers: int
    d_model: int
    vocab: int
    modality: str = "text"  # "text" | "vlm" | "audio"

    # ---- attention ----
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0  # fraction of head_dim that rotates (stablelm: 0.25)
    attn_logit_softcap: float = 0.0
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-6
    zero_centered_norm: bool = False  # gemma-style (1 + scale)
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d_model)
    pos_embed: str = "rope"  # "rope" | "sinusoidal" | "none"
    tie_embeddings: bool = False
    attn_chunk_q: int = 512  # q-block size for the chunked attention
    # flash attention: online-softmax over kv blocks — intermediates shrink
    # from (B,H,cq,S) to (B,H,cq,ckv). §Perf hillclimb knob; the naive
    # q-chunked implementation is the recorded baseline.
    flash_attention: bool = False
    attn_chunk_kv: int = 1024

    # ---- ffn ----
    d_ff: int = 0
    ffn_act: str = "silu"  # gated: "silu"=SwiGLU, "gelu"=GeGLU; "gelu_mlp"=ungated

    # ---- MoE ----
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    dense_d_ff: int = 0  # d_ff of the dense prefix layers
    capacity_factor: float = 1.25
    router_aux_coef: float = 1e-3
    # routing-group size in tokens (0 = one group per batch row). Smaller
    # groups shrink the GShard dispatch tensors (B,S,E,C) and the dispatch
    # einsum FLOPs linearly — §Perf hillclimb knob for the MoE giants.
    moe_group_tokens: int = 0
    # "einsum" = paper-faithful GShard dispatch; "sharded" = scatter-based
    # shard_map expert parallelism (§Perf B7) — requires an active mesh.
    moe_impl: str = "einsum"

    # ---- MLA (deepseek-v3) ----
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # ---- MTP (deepseek-v3) ----
    mtp_depth: int = 0

    # ---- SSM (mamba2 / SSD) ----
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_n_groups: int = 1

    # ---- hybrid (zamba2) ----
    hybrid_attn_every: int = 0  # shared attention block after every k-th mamba layer

    # ---- modality stubs ----
    n_prefix_embeds: int = 0  # vlm: precomputed patch-embedding prefix length
    inputs_are_embeds: bool = False  # audio: precomputed frame embeddings replace tokens

    # ---- numerics ----
    dtype: str = "bfloat16"  # activation/computation dtype
    param_dtype: str = "float32"
    vocab_pad_multiple: int = 0  # pad embedding rows for TP divisibility

    # ------------------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_multiple
        if not m:
            return self.vocab
        return -(-self.vocab // m) * m

    @property
    def qk_head_dim(self) -> int:
        if self.use_mla:
            return self.qk_nope_head_dim + self.qk_rope_head_dim
        return self.head_dim

    @property
    def v_dim(self) -> int:
        return self.v_head_dim if self.use_mla else self.head_dim

    @property
    def d_inner(self) -> int:  # mamba2
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_n_groups * self.ssm_state

    @property
    def has_attention(self) -> bool:
        return self.family in ("dense", "moe") or self.hybrid_attn_every > 0

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d = self.d_model
        n = 0
        if not self.inputs_are_embeds:
            n += self.vocab * d
        if not self.tie_embeddings:
            n += self.vocab * d
        if self.family in ("dense", "moe"):
            for layer in range(self.n_layers):
                n += self._attn_params()
                n += self._ffn_params(layer)
                n += 2 * d  # 2 norms (scale only; bias ignored for estimate)
        elif self.family == "ssm":
            n += self.n_layers * (self._mamba_params() + d)
        elif self.family == "hybrid":
            n += self.n_layers * (self._mamba_params() + d)
            if self.hybrid_attn_every:
                n += self._attn_params() + self._dense_ffn_params(self.d_ff) + 2 * d
        n += d  # final norm
        if self.mtp_depth:
            n += self.mtp_depth * (self._attn_params() + self._ffn_params(self.n_layers - 1)
                                   + 2 * d * self.d_model + 4 * d)
        return n

    def n_active_params(self) -> int:
        """Per-token active parameters (= n_params for non-MoE)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        n = self.vocab * d * (1 if self.tie_embeddings else 2)
        for layer in range(self.n_layers):
            n += self._attn_params() + 2 * d
            if layer < self.first_k_dense:
                n += self._dense_ffn_params(self.dense_d_ff)
            else:
                n += self.n_experts_per_tok * self._dense_ffn_params(self.moe_d_ff)
                n += self.n_shared_experts * self._dense_ffn_params(self.moe_d_ff)
                n += d * self.n_experts  # router
        n += d
        return n

    def _attn_params(self) -> int:
        d = self.d_model
        if self.use_mla:
            qk, v = self.qk_head_dim, self.v_head_dim
            n = d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qk
            n += d * (self.kv_lora_rank + self.qk_rope_head_dim)
            n += self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + v)
            n += self.n_heads * v * d
            n += self.q_lora_rank + self.kv_lora_rank  # lora norms
            return n
        hd = self.head_dim
        return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d

    def _dense_ffn_params(self, f: int) -> int:
        gated = self.ffn_act in ("silu", "gelu")
        return (3 if gated else 2) * self.d_model * f

    def _ffn_params(self, layer: int) -> int:
        if self.family == "moe" and layer >= self.first_k_dense:
            n = self.n_experts * self._dense_ffn_params(self.moe_d_ff)
            n += self.n_shared_experts * self._dense_ffn_params(self.moe_d_ff)
            n += self.d_model * self.n_experts
            return n
        f = self.dense_d_ff if (self.family == "moe" and self.dense_d_ff) else self.d_ff
        return self._dense_ffn_params(f)

    def _mamba_params(self) -> int:
        d, di = self.d_model, self.d_inner
        gn = self.ssm_n_groups * self.ssm_state
        n = d * (2 * di + 2 * gn + self.ssm_heads)  # in_proj
        n += self.ssm_conv * self.conv_dim + self.conv_dim  # conv1d
        n += 3 * self.ssm_heads  # A_log, D, dt_bias
        n += di  # gated norm
        n += di * d  # out_proj
        return n


# ---------------------------------------------------------------------------
# input-shape grid (assigned shapes; identical for every LM arch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(applicable, reason-if-not). long_500k needs sub-quadratic attention."""
    if shape == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "full quadratic attention — long_500k skipped (DESIGN.md §4)"
    return True, ""


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, dict[str, Callable[[], ModelConfig]]] = {}


def register(arch_id: str, full: Callable[[], ModelConfig], smoke: Callable[[], ModelConfig]):
    _REGISTRY[arch_id] = {"full": full, "smoke": smoke}


def get_config(arch_id: str, *, smoke: bool = False) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]["smoke" if smoke else "full"]()


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
