"""Per-architecture execution plans (microbatching, optimizer, FSDP, SP).

Port of ``repro.launch.plans``: ``TRAIN_PLANS``, ``SERVE_PARAM_DTYPE``,
the per-arch config overrides and their getters, read by
``launch/train.py`` and by the dry-run (``launch/dryrun.py``). The plans
were sized for the reference's accelerator:
  * dense 1.6B–14B — AdamW with an int8 first moment, microbatched;
  * the MoE giants — Adafactor (factored second moment), bf16 parameters
    and gradient accumulation, FSDP over ``data`` and sequence-sharded
    carries (read on a mesh: ``train.step.init_state(mesh=)`` and the
    step's ``act_spec``), 2 microbatches;
  * SSM/hybrid — small models; modest microbatching.
"""
from __future__ import annotations

from repro_torch.train.step import TrainPlan

TRAIN_PLANS: dict[str, TrainPlan] = {
    "gemma-7b": TrainPlan(microbatches=8, state_dtype="int8"),
    "qwen3-14b": TrainPlan(microbatches=16, state_dtype="int8"),
    "phi3-mini-3.8b": TrainPlan(microbatches=8, state_dtype="int8"),
    "stablelm-1.6b": TrainPlan(microbatches=4, state_dtype="int8"),
    "llava-next-mistral-7b": TrainPlan(microbatches=8, state_dtype="int8"),
    "musicgen-large": TrainPlan(microbatches=8, state_dtype="int8"),
    "zamba2-2.7b": TrainPlan(microbatches=16, state_dtype="int8"),
    "kimi-k2-1t-a32b": TrainPlan(
        microbatches=2, optimizer="adafactor", param_dtype="bfloat16",
        fsdp=True, seq_shard_acts=True, grad_accum_dtype="bfloat16"),
    "deepseek-v3-671b": TrainPlan(
        microbatches=2, optimizer="adafactor", param_dtype="bfloat16",
        fsdp=True, seq_shard_acts=True, grad_accum_dtype="bfloat16"),
    "mamba2-370m": TrainPlan(microbatches=2, state_dtype="int8"),
}

# serving always runs bf16 params / bf16 caches
SERVE_PARAM_DTYPE = "bfloat16"

# per-step config overrides: the MoE giants train with the scatter-based
# expert parallelism (on a mesh, under an activation context; without one
# the port's MoE is the grouped dispatch); their prefill uses flash
# attention and sequence sub-groups for the GShard dispatch tensors
TRAIN_CFG_OVERRIDES: dict[str, dict] = {
    "deepseek-v3-671b": {"moe_impl": "sharded"},
    "kimi-k2-1t-a32b": {"moe_impl": "sharded"},
}
PREFILL_CFG_OVERRIDES_COMMON: dict = {}
PREFILL_CFG_OVERRIDES: dict[str, dict] = {
    "deepseek-v3-671b": {"flash_attention": True, "moe_group_tokens": 2048},
    "kimi-k2-1t-a32b": {"flash_attention": True, "moe_group_tokens": 2048},
}


def train_plan(arch: str) -> TrainPlan:
    return TRAIN_PLANS[arch]


def train_cfg_overrides(arch: str) -> dict:
    return TRAIN_CFG_OVERRIDES.get(arch, {})


def prefill_cfg_overrides(arch: str) -> dict:
    return PREFILL_CFG_OVERRIDES.get(arch, dict(PREFILL_CFG_OVERRIDES_COMMON))
