"""The port's ``make_train_step`` against the JAX package's jitted step.

The smoke configs that ``chip_smoke.py`` phase 16 (a) trains on the card
— here dense (``stablelm``) and ssm (``mamba2``); moe with MLA and MTP
(``deepseek-v3``) and hybrid (``zamba2``) in ``test_torch_train_step_moe.py``,
which runs this file's ``_run`` — take three steps in both packages
from the same carried parameters (``convert.lm_params``) and the same
``SyntheticLM`` batches, under the three optimizer settings of phase 16
(a): AdamW with f32 moments and one microbatch, AdamW with the int8 first
moment and two microbatches, Adafactor with two microbatches. After each
step the loss and metrics, every parameter and the optimizer state (the
step, the moments — an int8 moment's ``q`` within one quantum, its scale —
and Adafactor's row and column statistics) equal JAX's, taken to its
layout with ``convert.lm_tree``. Under AdamW a few elements (at most
``FLIP_SHARE`` of a leaf) may differ by up to the peak learning rate
instead: Adam divides each element's moment by its own root second
moment, so an element whose gradient is at the float noise floor (a sum
that cancels) moves by anything up to ±lr in either package, and an int8
first moment whose value sits at a half quantum rounds either way; the
element's step follows it. JAX's step is jitted once per (arch,
plan). Also the bf16 gradient accumulator of the MoE giants' plans, and
the microbatch count that does not divide the batch.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.pipeline import BatchSpec as JBatchSpec  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.train import step as jstep  # noqa: E402

from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCHS = ("stablelm-1.6b", "mamba2-370m")
PLANS = {
    "adamw-f32": dict(optimizer="adamw", state_dtype="float32",
                      microbatches=1),
    "adamw-int8-mb2": dict(optimizer="adamw", state_dtype="int8",
                           microbatches=2),
    "adafactor-mb2": dict(optimizer="adafactor", microbatches=2),
}
STEPS, B, S = 3, 4, 32
TOL = dict(rtol=1e-4, atol=1e-5)
FLIP_SHARE = 1e-3  # of a leaf's elements, in the AdamW runs


def _plan(name: str, **over):
    kw = dict(PLANS[name], lr=1e-3, warmup=2, total_steps=10, **over)
    return jstep.TrainPlan(**kw), tstep.TrainPlan(**kw)


def _leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in flat}


def _held(got: dict, want: dict, label: str, *, flips: float = 0.0
          ) -> None:
    """Every leaf within TOL; an int8 moment's ``q`` within one quantum.
    With ``flips`` (a learning rate), up to FLIP_SHARE of a leaf's
    elements may differ by up to it instead (see the module docstring)."""
    assert set(got) == set(want), (label, set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        if k.endswith("['q']"):
            assert np.abs(g - w).max() <= 1, (label, k)
            continue
        off = ~np.isclose(g, w, **TOL)
        if flips and off.mean() <= FLIP_SHARE:
            assert np.abs(g - w)[off].max(initial=0) <= flips, (label, k)
            continue
        np.testing.assert_allclose(g, w, err_msg=f"{label} {k}", **TOL)


def _opt_tree(state: dict) -> dict:
    return {"step": np.asarray(int(state["step"])),
            **{k: convert.lm_tree(v) for k, v in state.items()
               if k != "step"}}


def _run(arch: str, plan_name: str, **over) -> None:
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = configs.get_config(arch, smoke=True)
    jplan, tplan = _plan(plan_name, **over)
    params, jopt = jstep.init_state(jax.random.PRNGKey(0), jcfg, jplan)
    jfn = jax.jit(jstep.make_train_step(jcfg, jplan))
    model = convert.lm_params(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    _, topt = tstep.init_state(tcfg, tplan, device="cpu")
    topt = tstep._opt(tplan)[1](dict(model.named_parameters()),
                                tstep._opt(tplan)[0])
    tfn = tstep.make_train_step(tcfg, tplan)
    src = JSyntheticLM(JBatchSpec(B, S, jcfg.vocab), seed=0)
    for i in range(STEPS):
        raw = src.batch_at(i)
        params, jopt, jm = jfn(params, jopt,
                               jtrain._adapt_batch(jcfg, raw))
        topt, tm = tfn(model, topt, ttrain._adapt_batch(tcfg, raw, "cpu"))
        label = f"{arch} {plan_name} step {i + 1}"
        assert set(tm) == set(jm), label
        for k, v in jm.items():
            np.testing.assert_allclose(float(tm[k]), float(v),
                                       err_msg=f"{label} {k}", **TOL)
        flips = tplan.lr if tplan.optimizer == "adamw" else 0.0
        _held(_leaves(convert.lm_tree(model)), _leaves(params),
              f"{label} params", flips=flips)
        _held(_leaves(_opt_tree(topt)), _leaves(jopt), f"{label} state",
              flips=flips)


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_equal_jax(arch, plan):
    _run(arch, plan)


def test_bf16_grad_accumulator_equals_jax():
    """The giants' bf16 gradient accumulator (each microbatch's gradient
    cast to bf16 and summed there, then / n and f32)."""
    _run("stablelm-1.6b", "adafactor-mb2", grad_accum_dtype="bfloat16")


def test_init_state_casts_every_floating_leaf_and_refuses_a_bad_split():
    cfg = configs.get_config("mamba2-370m", smoke=True)
    plan = tstep.TrainPlan(param_dtype="bfloat16", microbatches=3)
    model, opt = tstep.init_state(cfg, plan, device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 0
    toks = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(AssertionError):
        tstep.make_train_step(cfg, plan)(model, opt, {"tokens": toks,
                                                      "labels": toks})


def test_plan_fields_equal_the_reference():
    assert [f.name for f in dataclasses.fields(tstep.TrainPlan)] == \
        [f.name for f in dataclasses.fields(jstep.TrainPlan)]
    assert tstep.TrainPlan() == tstep.TrainPlan(
        **dataclasses.asdict(jstep.TrainPlan()))
