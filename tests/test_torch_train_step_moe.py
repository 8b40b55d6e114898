"""``make_train_step`` against JAX's jitted step for the moe family (MLA,
MTP and the MoE aux: ``deepseek-v3``) and the hybrid (``zamba2``): three
steps under each optimizer setting of ``chip_smoke.py`` phase 16 (a),
held as ``test_torch_train_step.py`` holds the dense and ssm configs
(its ``_run``)."""
import pytest

pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

from test_torch_train_step import PLANS, _run  # noqa: E402


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "zamba2-2.7b"])
def test_three_steps_equal_jax(arch, plan):
    _run(arch, plan)
