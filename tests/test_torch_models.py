"""The port's dense language models against the JAX package.

Parameters are carried across (``jax.tree_util.tree_map(np.asarray,
lm.init(PRNGKey(0), cfg))`` into ``convert.lm_params``) and the inputs drawn
from one numpy seed, so both packages run the same model:

* for each of the six dense smoke configs (four text models, the vlm and
  the audio stub; all f32): ``hidden``, the prefill's logits and every
  layer's k/v cache, and three decode steps' logits, within atol and rtol
  1e-4; ``greedy_generate``'s tokens equal. The JAX side runs once per arch
  in a module fixture. The prompt spans two query chunks;
* the flash form (``attn_chunk_kv=8``) against JAX's flash form and the
  port's chunked form, in the model and alone (GQA grouping, softcap);
* bf16 compute (``dtype="bfloat16"``) on stablelm and qwen3 within
  ``BF16_TOL``;
* a padded vocab: pad logits -1e30, the rest equal to JAX;
* the port alone: prefill + decode equals the full forward
  (``tests/test_models.py``'s property and tolerance); its own init has
  JAX's leaf names and shapes, equal norm parameters and each weight's
  std within 10% of JAX's (the moe family's parity is in
  ``tests/test_torch_moe.py``);
* ``lm_embed`` with a carried model equals JAX's; its own model gives unit
  norms; ``launch.serve.main`` runs on the CPU when asked.
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
from repro.bench import augment as jaug  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import lm_serving as jls  # noqa: E402

from repro_torch import configs, convert  # noqa: E402
from repro_torch.bench import augment as taug  # noqa: E402
from repro_torch.bench import datasets as tds  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import lm_serving as tls  # noqa: E402

DENSE = ("stablelm-1.6b", "qwen3-14b", "gemma-7b", "phi3-mini-3.8b",
         "llava-next-mistral-7b", "musicgen-large")
B = 2
PROMPT = 32  # positions the prefill fills: two chunks of attn_chunk_q=16
DECODE = 3
GREEDY = 6
TOL = dict(atol=1e-4, rtol=1e-4)
# bf16 rounds every activation to 8 significant bits, and XLA's CPU
# fusions round in other places than torch's op-by-op casts: over the
# smoke configs' two layers the packages part by up to 0.039 (one or two
# bf16 ulps of the hidden states' largest values, about 4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)


def _cfgs(arch: str, **over) -> tuple:
    j = dataclasses.replace(jconfigs.get_config(arch, smoke=True), **over)
    t = dataclasses.replace(configs.get_config(arch, smoke=True), **over)
    return j, t


def _inputs(cfg, seed: int = 0) -> tuple:
    """-> (the prompt batch, the DECODE steps' inputs), numpy: the prompt
    fills PROMPT positions (a vlm's patches included)."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    if cfg.inputs_are_embeds:
        emb = rng.normal(size=(B, PROMPT + DECODE, d)).astype(np.float32)
        return {"embeds": emb[:, :PROMPT]}, [
            {"embed": emb[:, PROMPT + i]} for i in range(DECODE)]
    n_tok = PROMPT - (cfg.n_prefix_embeds if cfg.modality == "vlm" else 0)
    toks = rng.integers(0, cfg.vocab, (B, n_tok + DECODE)).astype(np.int32)
    batch = {"tokens": toks[:, :n_tok]}
    if cfg.modality == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.n_prefix_embeds, d)).astype(np.float32)
    return batch, [{"token": toks[:, n_tok + i]} for i in range(DECODE)]


def _j(tree: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def _np(x) -> np.ndarray:
    """A copy in f32 (the port's decode writes its cache in place)."""
    return np.array(x.detach().float() if isinstance(x, torch.Tensor) else x,
                    np.float32)


def _run_jax(cfg, params, batch, steps) -> dict:
    """hidden, the prefill's logits and cache, the decode steps' logits."""
    max_len = PROMPT + DECODE + 1
    h, _ = jax.jit(lambda p, b: jlm.hidden(p, cfg, b))(params, _j(batch))
    logits, cache = jax.jit(jls.make_prefill_step(cfg, max_len))(
        params, _j(batch))
    out = dict(hidden=_np(h), prefill=_np(logits),
               cache=jax.tree_util.tree_map(np.asarray, cache), decode=[])
    decode = jax.jit(jls.make_decode_step(cfg))
    for i, inp in enumerate(steps):
        logits, cache = decode(params, _j(inp),
                               jnp.asarray(PROMPT + i, jnp.int32), cache)
        out["decode"].append(_np(logits))
    return out


def _run_port(model, batch, steps) -> dict:
    max_len = PROMPT + DECODE + 1
    tb = _t(batch)
    h = tlm.hidden(model, tb)
    logits, cache = tlm.prefill(model, tb, max_len)
    out = dict(hidden=_np(h), prefill=_np(logits),
               cache={k: _np(v) for k, v in cache["attn"].items()},
               decode=[])
    for i, inp in enumerate(steps):
        logits, cache = tlm.decode_step(model, _t(inp), PROMPT + i, cache)
        out["decode"].append(_np(logits))
    return out


def _assert_runs_equal(port: dict, ref: dict, tol: dict, label: str):
    np.testing.assert_allclose(port["hidden"], ref["hidden"], **tol,
                               err_msg=f"{label} hidden")
    np.testing.assert_allclose(port["prefill"], ref["prefill"], **tol,
                               err_msg=f"{label} prefill logits")
    for i, (a, b) in enumerate(zip(port["decode"], ref["decode"], strict=True)):
        np.testing.assert_allclose(a, b, **tol,
                                   err_msg=f"{label} decode step {i}")


def _carried(jcfg, tcfg) -> tuple:
    params = jax.tree_util.tree_map(
        np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg))
    return params, convert.lm_params(params, tcfg, device="cpu")


@pytest.fixture(scope="module", params=DENSE)
def jax_side(request):
    """One arch's carried parameters, inputs and the JAX package's run."""
    jcfg, tcfg = _cfgs(request.param)
    params, model = _carried(jcfg, tcfg)
    batch, steps = _inputs(jcfg)
    ref = _run_jax(jcfg, params, batch, steps)
    ref["greedy"] = np.asarray(jls.greedy_generate(
        params, jcfg, _j(batch), steps=GREEDY, max_len=PROMPT + GREEDY + 1))
    return dict(arch=request.param, cfg=tcfg, model=model, batch=batch,
                steps=steps, ref=ref)


def test_port_matches_jax(jax_side):
    s = jax_side
    port = _run_port(s["model"], s["batch"], s["steps"])
    _assert_runs_equal(port, s["ref"], TOL, s["arch"])
    n_layers = s["cfg"].n_layers
    for name in ("k", "v"):
        got, want = port["cache"][name], s["ref"]["cache"]["attn"][name]
        assert got.shape == want.shape
        for layer in range(n_layers):
            np.testing.assert_allclose(
                got[layer], want[layer], **TOL,
                err_msg=f"{s['arch']} layer {layer} cache {name}")


def test_greedy_generate_matches_jax(jax_side):
    s = jax_side
    toks = tls.greedy_generate(s["model"], _t(s["batch"]), steps=GREEDY,
                               max_len=PROMPT + GREEDY + 1)
    assert toks.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(), s["ref"]["greedy"])


def test_flash_model_matches_jax_flash_and_port_chunked():
    jcfg, tcfg = _cfgs("qwen3-14b", flash_attention=True, attn_chunk_kv=8)
    params, model = _carried(jcfg, tcfg)
    batch, steps = _inputs(jcfg, seed=1)
    port = _run_port(model, batch, steps)
    _assert_runs_equal(port, _run_jax(jcfg, params, batch, steps), TOL,
                       "flash vs JAX flash")
    chunked = dataclasses.replace(tcfg, flash_attention=False)
    _assert_runs_equal(port, _run_port(convert.lm_params(params, chunked,
                                                         device="cpu"),
                                       batch, steps), TOL,
                       "flash vs port chunked")


@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_attention_forms_match_jax(softcap):
    """Both forms alone: 4 query heads over 2 kv heads (head h reads kv
    head h // 2), 4 query and kv chunks, an offset query block."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 32, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
    kw = dict(scale=0.25, softcap=softcap, q_offset=8)
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    chunked = tattn.chunked_causal_attention(tq, tk, tv, q_chunk=8, **kw)
    flash = tattn.flash_causal_attention(tq, tk, tv, q_chunk=8, kv_chunk=10,
                                         **kw)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(
        jattn.chunked_causal_attention(jq, jk, jv, q_chunk=8, **kw)), **TOL)
    np.testing.assert_allclose(flash.numpy(), np.asarray(
        jattn.flash_causal_attention(jq, jk, jv, q_chunk=8, kv_chunk=10,
                                     **kw)), **TOL)
    np.testing.assert_allclose(flash.numpy(), chunked.numpy(), **TOL)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen3-14b"])
def test_bf16_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    params, model = _carried(jcfg, tcfg)
    batch, steps = _inputs(jcfg, seed=2)
    port = _run_port(model, batch, steps)
    assert tlm.hidden(model, _t(batch)).dtype == torch.bfloat16
    _assert_runs_equal(port, _run_jax(jcfg, params, batch, steps), BF16_TOL,
                       f"{arch} bf16")


def test_padded_vocab_masks_pad_logits():
    jcfg, tcfg = _cfgs("stablelm-1.6b", vocab_pad_multiple=48)
    assert tcfg.vocab_padded == 288 and tcfg.vocab == 256
    params, model = _carried(jcfg, tcfg)
    batch, steps = _inputs(jcfg, seed=4)
    port = _run_port(model, batch, steps)
    for logits in [port["prefill"], *port["decode"]]:
        assert logits.shape[-1] == 288
        assert (logits[:, 256:] == -1e30).all()
    _assert_runs_equal(port, _run_jax(jcfg, params, batch, steps), TOL,
                       "padded vocab")


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """``tests/test_models.py``'s property on the port's own init: prefill
    + one decode step give the full forward's logits at both positions."""
    cfg = configs.get_config(arch, smoke=True)
    model = tlm.init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    b, p_len = 2, 12
    if cfg.inputs_are_embeds:
        emb = torch.as_tensor(rng.normal(size=(b, p_len + 1, cfg.d_model)),
                              dtype=torch.float32)
        batch, full = {"embeds": emb[:, :p_len]}, {"embeds": emb}
        inp, total = {"embed": emb[:, p_len]}, p_len
    else:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, p_len + 1)),
                               dtype=torch.int32)
        batch, full = {"tokens": toks[:, :p_len]}, {"tokens": toks}
        inp, total = {"token": toks[:, p_len]}, p_len
        if cfg.modality == "vlm":
            pe = torch.as_tensor(rng.normal(size=(b, cfg.n_prefix_embeds,
                                                  cfg.d_model)),
                                 dtype=torch.float32)
            batch["patch_embeds"] = full["patch_embeds"] = pe
            total += cfg.n_prefix_embeds
    logits_pre, cache = tlm.prefill(model, batch, max_len=total + 4)
    logits_dec, _ = tlm.decode_step(model, inp, total, cache)
    h = tlm.hidden(model, full)
    np.testing.assert_allclose(_np(logits_dec), _np(tlm.unembed(model, h[:, -1])),
                               atol=2e-2, rtol=2e-3)
    np.testing.assert_allclose(_np(logits_pre), _np(tlm.unembed(model, h[:, -2])),
                               atol=2e-2, rtol=2e-3)


@pytest.mark.parametrize("arch", DENSE)
def test_own_init_has_jax_names_shapes_and_scales(arch):
    jcfg, tcfg = _cfgs(arch)
    params = jax.tree_util.tree_map(
        np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg))
    model = tlm.init(tcfg, seed=0, device="cpu")
    named = dict(model.named_parameters())
    assert set(named) == convert.lm_names(params)
    for name, t in named.items():
        ref = convert.lm_leaf(params, name)
        got = t.detach().numpy()
        assert got.shape == ref.shape, name
        if "norm" in name or name.endswith(".b"):  # ones / zeros
            np.testing.assert_array_equal(got, ref, err_msg=name)
            continue
        # the stacked leaf's std over all layers against the port's layers
        stacked = (np.asarray(params["blocks"][name.split(".")[2]][
            name.split(".")[3]]) if name.startswith("blocks.") else ref)
        assert abs(got.std() / stacked.std() - 1.0) < 0.10, name


def test_lm_embed_matches_jax_and_is_normalized():
    scalars, _ = tds._scalar_table(64, 0)
    jcfg, tcfg = _cfgs("stablelm-1.6b")
    _, model = _carried(jcfg, tcfg)
    ref = jaug.lm_embed(scalars, 16, smoke=True, seed=0, batch=24)
    got = taug.lm_embed(scalars, 16, seed=0, batch=24, model=model)
    assert got.shape == (64, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5)
    own = taug.lm_embed(scalars, 16, seed=0, device="cpu")
    assert np.isfinite(own).all()
    np.testing.assert_allclose(np.linalg.norm(own, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("arch", DENSE)
def test_serve_main_runs_on_the_cpu(arch, capsys):
    toks = tserve.main(["--arch", arch, "--smoke", "--batch", "2",
                        "--prompt-len", "16", "--steps", "4"], device="cpu")
    vocab = configs.get_config(arch, smoke=True).vocab
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    assert toks.device.type == "cpu"
    assert ((toks >= 0) & (toks < vocab)).all()
    assert "first sequence" in capsys.readouterr().out
