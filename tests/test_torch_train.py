"""The port's training loss and its gradients against the JAX package.

For the smoke configs of every family — dense (``stablelm``), moe with MLA
and MTP (``deepseek-v3``), ssm (``mamba2``), hybrid (``zamba2``), the vlm
stub (``llava-next``) and the audio stub (``musicgen``) — the JAX
``lm.init`` tree is carried into the port (``convert.lm_params``) and one
``SyntheticLM`` batch goes through each package's ``launch.train.
_adapt_batch``. The port's ``lm.loss_fn``, its metrics and every gradient
leaf (taken back to JAX's layout with ``convert.lm_tree``) are held to
``jax.value_and_grad(lm.loss_fn)`` at f32 (rtol 1e-4, atol 1e-5), with
the port's remat on and off; the JAX side is jitted once per arch in a
module fixture. Also: ``_pick_chunk`` and ``chunked_ce`` at a forced
chunk; the pad columns of a padded vocab get no gradient; remat frees
the blocks' activations.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import cap  # noqa: E402

cap()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.pipeline import BatchSpec as JBatchSpec  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402

from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

ARCHS = ("stablelm-1.6b", "deepseek-v3-671b", "mamba2-370m", "zamba2-2.7b",
         "llava-next-mistral-7b", "musicgen-large")
B, S = 2, 32  # two SSD chunks of the smoke configs' 16
TOL = dict(rtol=1e-4, atol=1e-5)


def _cfgs(arch: str, **over) -> tuple:
    j = dataclasses.replace(jconfigs.get_config(arch, smoke=True), **over)
    t = dataclasses.replace(configs.get_config(arch, smoke=True), **over)
    return j, t


def _leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in flat}


def _batches(jcfg, tcfg, seed: int = 0) -> tuple:
    raw = JSyntheticLM(JBatchSpec(B, S, jcfg.vocab), seed=seed).batch_at(1)
    return (jtrain._adapt_batch(jcfg, raw),
            ttrain._adapt_batch(tcfg, raw, "cpu"))


def _jax_run(arch: str, **over) -> dict:
    jcfg, tcfg = _cfgs(arch, **over)
    params = jlm.init(jax.random.PRNGKey(0), jcfg)
    jb, tb = _batches(jcfg, tcfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(params, jb)
    return dict(tcfg=tcfg, tree=jax.tree.map(np.asarray, params), batch=tb,
                loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=_leaves(grads))


@pytest.fixture(scope="module")
def ref():
    cache: dict = {}

    def get(arch: str) -> dict:
        if arch not in cache:
            cache[arch] = _jax_run(arch)
        return cache[arch]

    return get


def _port_grads(run: dict, remat: bool) -> tuple:
    model = convert.lm_params(run["tree"], run["tcfg"], device="cpu")
    loss, metrics = tlm.loss_fn(model, run["batch"], remat=remat)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    named = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    return loss, metrics, _leaves(convert.lm_tree(named))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_metrics_and_every_gradient_equal_jax(ref, arch, remat):
    run = ref(arch)
    loss, metrics, grads = _port_grads(run, remat)
    np.testing.assert_allclose(float(loss.detach()), run["loss"], **TOL)
    assert set(metrics) == set(run["metrics"])
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v.detach()), run["metrics"][k],
                                   err_msg=k, **TOL)
    assert set(grads) == set(run["grads"])
    for k, g in run["grads"].items():
        np.testing.assert_allclose(grads[k], g, err_msg=k, **TOL)


def test_metric_keys_follow_the_family(ref):
    assert set(ref("stablelm-1.6b")["metrics"]) == {"ce", "z_sq", "loss"}
    assert set(ref("deepseek-v3-671b")["metrics"]) == {
        "ce", "z_sq", "loss", "mtp_ce", *tlm.AUX_KEYS}


def test_padded_vocab_loss_and_no_gradient_to_pad_columns():
    """A vocab padded past ``vocab``: the pad logits are -1e30 in place
    under autograd and under the chunks' recompute, the loss and
    gradients equal JAX's, and no pad row of the head gets a gradient."""
    run = _jax_run("stablelm-1.6b", vocab=250, vocab_pad_multiple=128,
                   tie_embeddings=False)
    cfg = run["tcfg"]
    assert cfg.vocab_padded > cfg.vocab
    loss, _, grads = _port_grads(run, remat=True)
    np.testing.assert_allclose(float(loss.detach()), run["loss"], **TOL)
    for k, g in run["grads"].items():
        np.testing.assert_allclose(grads[k], g, err_msg=k, **TOL)
    head = grads["['lm_head']['w']"]
    assert np.all(head[:, cfg.vocab:] == 0)
    assert np.any(head[:, : cfg.vocab] != 0)


def test_pick_chunk_and_forced_chunks():
    for s in (2048, 4096, 96, 63, 1):
        assert tlm._pick_chunk(s) == jlm._pick_chunk(s), s
    jcfg, tcfg = _cfgs("stablelm-1.6b")
    params = jlm.init(jax.random.PRNGKey(1), jcfg)
    model = convert.lm_params(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    rng = np.random.default_rng(3)
    h = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(-1, jcfg.vocab, (B, S)).astype(np.int32)
    for chunk in (0, 4, 8):
        want = jlm.chunked_ce(params, jcfg, jnp.asarray(h),
                              jnp.asarray(labels), chunk=chunk)
        got = tlm.chunked_ce(model, torch.tensor(h), torch.tensor(labels),
                             chunk=chunk)
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g.detach()), float(w), **TOL)


def test_remat_recomputes_instead_of_saving():
    """With remat the forward keeps fewer saved tensors for the backward
    than without, and ``hidden`` keeps none (it runs without autograd)."""
    _, cfg = _cfgs("stablelm-1.6b")
    model = tlm.LM(cfg, seed=0, device="cpu")
    toks = torch.zeros((1, S), dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}

    def saved(remat: bool) -> int:
        n = 0

        def pack(t):
            nonlocal n
            n += t.numel()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tlm.loss_fn(model, batch, remat=remat)
        return n

    assert saved(True) < saved(False)
    assert not tlm.hidden(model, {"tokens": toks}).requires_grad


def test_mtp_loss_in_bf16_follows_the_reference_promotion():
    """bf16 compute on f32 parameters: MTP's projection promotes to f32
    (its f32 weight against the bf16 inputs) and its block then runs in
    f32 on the bf16-rounded weights, as JAX's type promotion has it."""
    jcfg, tcfg = _cfgs("deepseek-v3-671b", dtype="bfloat16")
    params = jlm.init(jax.random.PRNGKey(4), jcfg)
    model = convert.lm_params(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    rng = np.random.default_rng(5)
    h = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    want = jlm._mtp_loss(params, jcfg, jnp.asarray(h, jnp.bfloat16), jb)
    got = tlm._mtp_loss(model, torch.tensor(h).to(torch.bfloat16),
                        {k: torch.tensor(toks) for k in ("tokens",
                                                         "labels")})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
