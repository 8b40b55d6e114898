"""The port's SSM and hybrid language models against the JAX package.

Parameters are carried across (``jax.tree_util.tree_map(np.asarray,
lm.init(PRNGKey(0), cfg))`` into ``convert.lm_params``) and the inputs drawn
from one numpy seed, so both packages run the same model:

* ``ssd_scan`` against JAX's and against the step-by-step recurrence, with
  and without ``state_in`` (atol 1e-5); a chunk that does not divide the
  length is refused;
* ``mamba_apply(return_state=True)`` and two ``mamba_decode`` steps against
  JAX's on the same parameters;
* for ``mamba2-smoke`` and ``zamba2-smoke`` (f32): ``hidden``, the
  prefill's logits, every layer's conv windows and state (and the hybrid's
  k/v), three decode steps' logits (fed JAX's greedy tokens), within atol
  and rtol 1e-4; ``greedy_generate``'s tokens equal to the reference's
  greedy loop. The JAX side is one jitted program per arch, run once in a
  module fixture; the prompt spans two SSD chunks;
* bf16 compute: JAX's ``prefill`` raises ``TypeError`` (its ssm and hybrid
  prefills use the mamba blocks' f32 parameters, ROADMAP Queue 3), so the
  port's bf16 prefill is held to what JAX does run, within ``BF16_TOL``:
  JAX's bf16 ``hidden`` at the last position, and JAX's bf16 decode run
  token by token from ``make_cache`` over the prompt, for every layer's
  ``conv_x``, ``conv_bc`` and ``state``;
* the port alone: prefill + decode equals the full forward; its own init
  has JAX's leaf names and shapes and draws the reference's laws, and
  ``cast_blocks`` keeps ``A_log``, ``D`` and ``dt_bias`` f32;
* a padded vocab (pad logits -1e30, the rest the unpadded model's),
  attention at zamba2's head_dim 80,
  ``launch.serve.main`` on the CPU, ``lm_embed`` over ``mamba2-smoke``.
"""
import dataclasses
import functools

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
from repro.models import mamba2 as jm  # noqa: E402

from repro_torch import configs, convert  # noqa: E402
from repro_torch.bench import augment as taug  # noqa: E402
from repro_torch.bench import datasets as tds  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import lm_serving as tls  # noqa: E402
from repro_torch.models import mamba2 as tm  # noqa: E402

ARCHS = ("mamba2-370m", "zamba2-2.7b")
B = 2
PROMPT = 32  # two chunks of the smoke configs' ssm_chunk=16
DECODE = 3
GREEDY = 6
MAX_LEN = PROMPT + GREEDY + 1  # one cache length for every JAX call
TOL = dict(atol=1e-4, rtol=1e-4)
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16 rounds every activation to 8 significant bits; JAX's own bf16
# token-by-token decode parts from its bf16 forward by as much (0.019 and
# 0.053 on these inputs)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)


def _cfgs(arch: str, **over) -> tuple:
    j = dataclasses.replace(jconfigs.get_config(arch, smoke=True), **over)
    t = dataclasses.replace(configs.get_config(arch, smoke=True), **over)
    return j, t


def _carried(jcfg, tcfg) -> tuple:
    params = jax.tree_util.tree_map(
        np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg))
    return params, convert.lm_params(params, tcfg, device="cpu")


def _tokens(cfg, seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, n)).astype(np.int32)


def _np(x) -> np.ndarray:
    """A copy in f32 (the port's decode writes its cache in place)."""
    return np.array(x.detach().float() if isinstance(x, torch.Tensor) else x,
                    np.float32)


def _cache_np(cache: dict) -> dict:
    return {kind: {k: _np(v) for k, v in c.items()}
            for kind, c in cache.items()}


def _jax_run(jcfg):
    """One jitted JAX program (so each config compiles once): ``hidden``,
    the prefill's logits and cache, then ``jls.greedy_generate``'s loop
    over the same decode step (argmax over the real vocab, fed back) for
    GREEDY steps -> (hidden, logits, cache, the tokens fed (B, GREEDY),
    each step's logits (GREEDY, B, V))."""
    prefill = jls.make_prefill_step(jcfg, MAX_LEN)
    decode = jls.make_decode_step(jcfg)

    def greedy(logits):
        return jnp.argmax(logits[..., : jcfg.vocab], axis=-1).astype(
            jnp.int32)

    def run(params, prompt):
        h, _ = jlm.hidden(params, jcfg, prompt)
        logits, cache = prefill(params, prompt)

        def step(carry, i):
            tok, c = carry
            out, c = decode(params, {"token": tok}, PROMPT + i, c)
            return (greedy(out), c), (tok, out)

        _, (fed, outs) = jax.lax.scan(step, (greedy(logits), cache),
                                      jnp.arange(GREEDY, dtype=jnp.int32))
        return h, logits, cache, fed.T, outs

    return jax.jit(run)


@pytest.fixture(scope="module", params=ARCHS)
def jax_side(request):
    """One arch's carried parameters, prompt and the JAX package's run
    (``_jax_run``)."""
    jcfg, tcfg = _cfgs(request.param)
    params, model = _carried(jcfg, tcfg)
    toks = _tokens(jcfg, 0, PROMPT)
    h, logits, cache, fed, outs = _jax_run(jcfg)(
        params, {"tokens": jnp.asarray(toks)})
    ref = dict(hidden=_np(h), prefill=_np(logits),
               cache=jax.tree_util.tree_map(_np, cache),
               greedy=np.array(fed), decode=_np(outs))
    return dict(arch=request.param, cfg=tcfg, model=model, toks=toks,
                ref=ref)


# ---------------------------------------------------------------------------
# the SSD scan and one mamba layer
# ---------------------------------------------------------------------------

def _scan_inputs(seed: int = 0, b=2, s=32, h=4, p=8, n=16) -> dict:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    a = -np.exp(rng.uniform(0.0, 1.5, size=h)).astype(np.float32)
    bm = rng.normal(size=(b, s, h, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, h, n)).astype(np.float32)
    st = rng.normal(size=(b, h, n, p)).astype(np.float32)
    return dict(x=x, dt=dt, A=a, B_=bm, C_=cm, state_in=st)


def _recurrence(x, dt, A, B_, C_, state_in) -> tuple:
    """The SSM one step at a time (float64): state = exp(dt·A)·state +
    dt·B⊗x, y = C·state."""
    b, s, h, p = x.shape
    state = state_in.astype(np.float64)
    y = np.zeros((b, s, h, p))
    for t in range(s):
        decay = np.exp(dt[:, t] * A)[:, :, None, None]
        state = decay * state + np.einsum("bh,bhn,bhp->bhnp", dt[:, t],
                                          B_[:, t], x[:, t])
        y[:, t] = np.einsum("bhn,bhnp->bhp", C_[:, t], state)
    return y, state


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_matches_jax_and_the_recurrence(with_state):
    a = _scan_inputs(seed=int(with_state))
    if not with_state:
        a["state_in"] = np.zeros_like(a["state_in"])
    kw = {k: v for k, v in a.items() if with_state or k != "state_in"}
    y_t, s_t = tm.ssd_scan(**{k: torch.as_tensor(v) for k, v in kw.items()},
                           chunk=8)
    # JAX's side always takes a state (zeros without one: the same math),
    # so both cases run one compiled program
    y_j, s_j = jax.jit(functools.partial(jm.ssd_scan, chunk=8))(
        **{k: jnp.asarray(v) for k, v in a.items()})
    assert y_t.dtype == s_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **SCAN_TOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **SCAN_TOL)
    y_r, s_r = _recurrence(**a)
    np.testing.assert_allclose(y_t.numpy(), y_r, **SCAN_TOL)
    np.testing.assert_allclose(s_t.numpy(), s_r, **SCAN_TOL)


def test_ssd_scan_refuses_a_chunk_that_does_not_divide():
    a = {k: torch.as_tensor(v) for k, v in _scan_inputs(s=24).items()}
    with pytest.raises(ValueError, match="not a multiple"):
        tm.ssd_scan(a["x"], a["dt"], a["A"], a["B_"], a["C_"], chunk=16)
    # shorter than the chunk: one chunk of the whole length
    y, _ = tm.ssd_scan(a["x"], a["dt"], a["A"], a["B_"], a["C_"], chunk=32)
    assert y.shape == a["x"].shape and torch.isfinite(y).all()


def test_mamba_layer_and_decode_match_jax():
    """One layer on the same parameters (the port's own draw, given to
    both): the full sequence with its final state, then two decode steps
    from that state."""
    jcfg, tcfg = _cfgs("mamba2-370m")
    layer = tm.Mamba(tcfg, generator=torch.Generator().manual_seed(3))
    tp = tlm.param_tree(layer.requires_grad_(False))
    params = jax.tree_util.tree_map(lambda t: jnp.asarray(_np(t)), tp)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, PROMPT, tcfg.d_model)).astype(np.float32)
    steps = rng.normal(size=(2, B, 1, tcfg.d_model)).astype(np.float32)
    y_j, st_j = jax.jit(lambda p, v: jm.mamba_apply(
        p, jcfg, v, return_state=True))(params, jnp.asarray(x))
    jdecode = jax.jit(lambda p, v, c: jm.mamba_decode(p, jcfg, v, c))
    y_t, st_t = tm.mamba_apply(tp, tcfg, torch.as_tensor(x),
                               return_state=True)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    for k in ("conv_x", "conv_bc", "state"):
        np.testing.assert_allclose(_np(st_t[k]), np.asarray(st_j[k]), **TOL,
                                   err_msg=k)
    cache = {k: v.clone() for k, v in st_t.items()}
    for i, xi in enumerate(steps):
        o_j, st_j = jdecode(params, jnp.asarray(xi), st_j)
        o_t, cache = tm.mamba_decode(tp, tcfg, torch.as_tensor(xi), cache)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL,
                                   err_msg=f"step {i}")
        for k in ("conv_x", "conv_bc", "state"):
            np.testing.assert_allclose(_np(cache[k]), np.asarray(st_j[k]),
                                       **TOL, err_msg=f"step {i} {k}")


# ---------------------------------------------------------------------------
# the two families against JAX
# ---------------------------------------------------------------------------

def test_port_matches_jax(jax_side):
    s, ref = jax_side, jax_side["ref"]
    model = s["model"]
    prompt = {"tokens": torch.as_tensor(s["toks"])}
    np.testing.assert_allclose(_np(tlm.hidden(model, prompt)), ref["hidden"],
                               **TOL, err_msg="hidden")
    logits, cache = tlm.prefill(model, prompt, MAX_LEN)
    np.testing.assert_allclose(_np(logits), ref["prefill"], **TOL,
                               err_msg="prefill logits")
    got = _cache_np(cache)
    assert set(got) == set(ref["cache"]) == (
        {"mamba", "attn"} if s["cfg"].family == "hybrid" else {"mamba"})
    for kind, c in got.items():
        for name, v in c.items():
            want = ref["cache"][kind][name]
            assert v.shape == want.shape, (kind, name)
            for layer in range(v.shape[0]):
                np.testing.assert_allclose(
                    v[layer], want[layer], **TOL,
                    err_msg=f"{s['arch']} layer {layer} cache {kind} {name}")
    fed = torch.as_tensor(ref["greedy"])  # JAX's tokens, fed to both
    for i in range(DECODE):
        logits, cache = tlm.decode_step(model, {"token": fed[:, i]},
                                        PROMPT + i, cache)
        np.testing.assert_allclose(_np(logits), ref["decode"][i], **TOL,
                                   err_msg=f"decode step {i}")


def test_greedy_generate_matches_jax(jax_side):
    s = jax_side
    toks = tls.greedy_generate(
        s["model"], {"tokens": torch.as_tensor(s["toks"])},
        steps=GREEDY, max_len=MAX_LEN)
    assert toks.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(), s["ref"]["greedy"])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_held_to_jax_hidden_and_token_decode(arch):
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    params, model = _carried(jcfg, tcfg)
    toks = _tokens(jcfg, 2, PROMPT)
    prompt = {"tokens": jnp.asarray(toks)}
    # the reference's own bf16 prefill does not run (ROADMAP Queue 3): its
    # trace already fails
    with pytest.raises(TypeError, match="carry"):
        jax.eval_shape(lambda p, b: jlm.prefill(p, jcfg, b, PROMPT + 1),
                       params, prompt)

    def run(p, b):
        """JAX's bf16 forward's last logits; its decode from make_cache,
        token by token over the prompt."""
        h, _ = jlm.hidden(p, jcfg, b)
        decode = jls.make_decode_step(jcfg)

        def step(c, i):
            return decode(p, {"token": b["tokens"][:, i]}, i, c)[1], None

        cache, _ = jax.lax.scan(step, jlm.make_cache(jcfg, B, PROMPT + 1),
                                jnp.arange(PROMPT, dtype=jnp.int32))
        return jlm.unembed(p, jcfg, h[:, -1]), cache

    want, cache = jax.jit(run)(params, prompt)
    logits, got = tlm.prefill(model, {"tokens": torch.as_tensor(toks)},
                              PROMPT + 1)
    assert tlm.hidden(model, {"tokens": torch.as_tensor(toks)}).dtype == \
        torch.bfloat16
    assert got["mamba"]["conv_x"].dtype == torch.bfloat16
    assert got["mamba"]["state"].dtype == torch.float32
    np.testing.assert_allclose(_np(logits), _np(want), **BF16_TOL,
                               err_msg="prefill against JAX's bf16 hidden")
    for name, v in got["mamba"].items():
        ref = _np(cache["mamba"][name])
        for layer in range(tcfg.n_layers):
            np.testing.assert_allclose(
                _np(v[layer]), ref[layer], **BF16_TOL,
                err_msg=f"{arch} layer {layer} {name} against JAX's "
                        f"token-by-token bf16 decode")


def test_padded_vocab_masks_pad_logits(jax_side):
    """The model padded to 288 rows (the first 256 carried, 32 more
    drawn): pad logits -1e30, the real ones those of the unpadded model,
    which ``test_port_matches_jax`` holds to JAX."""
    s = jax_side
    cfg = dataclasses.replace(s["cfg"], vocab_pad_multiple=48)
    assert cfg.vocab_padded == 288 and cfg.vocab == 256
    padded = tlm.init(cfg, device="cpu")
    src = dict(s["model"].named_parameters())
    with torch.no_grad():
        for name, t in padded.named_parameters():
            t[tuple(slice(0, n) for n in src[name].shape)].copy_(src[name])
    prompt = {"tokens": torch.as_tensor(s["toks"])}
    nxt = {"token": torch.as_tensor(s["ref"]["greedy"][:, 0])}

    def run(model):
        logits, cache = tlm.prefill(model, prompt, PROMPT + 1)
        step, _ = tlm.decode_step(model, nxt, PROMPT, cache)
        return logits, step

    for got, want in zip(run(padded), run(s["model"])):
        assert got.shape[-1] == 288 and (got[:, 256:] == -1e30).all()
        np.testing.assert_allclose(got[:, :256].numpy(), want.numpy(),
                                   atol=1e-6, rtol=1e-6)
    if cfg.tie_embeddings:
        assert padded.embed.table.shape == (288, cfg.d_model)
    else:
        assert padded.lm_head.w.shape == (cfg.d_model, 288)


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """``tests/test_models.py``'s property on the port's own init: prefill
    (one SSD chunk) + decode steps give the full forward's logits (two
    chunks) at the same positions."""
    cfg = configs.get_config(arch, smoke=True)
    model = tlm.init(cfg, seed=0, device="cpu")
    toks = torch.as_tensor(_tokens(cfg, 5, 2 * cfg.ssm_chunk))
    p_len, steps = cfg.ssm_chunk, 4
    h = tlm.hidden(model, {"tokens": toks})
    want = tlm.unembed(model, h[:, p_len - 1: p_len + steps])
    logits, cache = tlm.prefill(model, {"tokens": toks[:, :p_len]},
                                p_len + steps)
    got = [logits]
    for i in range(steps):
        logits, cache = tlm.decode_step(model, {"token": toks[:, p_len + i]},
                                        p_len + i, cache)
        got.append(logits)
    np.testing.assert_allclose(_np(torch.stack(got, 1)), _np(want),
                               atol=2e-2, rtol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_own_init_has_jax_names_shapes_and_dtypes(arch):
    """The port's own init: JAX's leaf names and shapes, all f32; the
    deterministic leaves (``A_log``, ``D``, the norms, the conv biases)
    equal JAX's; ``cast_blocks`` in bf16 keeps ``A_log``, ``D`` and
    ``dt_bias`` f32 and copies the hybrid's shared block once."""
    jcfg, tcfg = _cfgs(arch)
    params = jax.tree_util.tree_map(
        np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg))
    model = tlm.init(tcfg, seed=0, device="cpu")
    named = dict(model.named_parameters())
    assert set(named) == convert.lm_names(params)
    for name, t in named.items():
        ref, got = convert.lm_leaf(params, name), t.detach().numpy()
        assert got.shape == ref.shape and got.dtype == np.float32, name
        leaf = name.split(".")[-1]
        if leaf in ("A_log", "D", "conv_x_b", "conv_bc_b") or "norm" in name:
            np.testing.assert_allclose(got, ref, rtol=1e-6, err_msg=name)
    bf = tlm.cast_blocks(tlm.init(dataclasses.replace(tcfg,
                                                      dtype="bfloat16"),
                                  device="cpu"))
    assert len(bf["blocks"]) == tcfg.n_layers
    mamba = bf["blocks"][0]["mamba"]
    for leaf in ("A_log", "D", "dt_bias"):
        assert mamba[leaf].dtype == torch.float32, leaf
    assert mamba["in_z"].dtype == mamba["norm"]["scale"].dtype == \
        torch.bfloat16
    assert ("shared_attn" in bf) == (tcfg.family == "hybrid")
    if tcfg.family == "hybrid":
        assert bf["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16


def test_mamba_init_draws_the_reference_laws():
    """One layer wide enough to sample each law (512 heads): every weight
    a normal truncated at two std of ``lecun_normal`` (1/sqrt(fan_in)) or,
    for the convs, of 1/sqrt(width); dt = softplus(dt_bias) log-uniform in
    [1e-3, 0.1]; ``A_log = log(linspace(1, 16, H))``, ``D = 1``."""
    cfg = dataclasses.replace(configs.get_config("mamba2-370m", smoke=True),
                              d_model=256, ssm_head_dim=1, ssm_state=128)
    layer = tm.Mamba(cfg, generator=torch.Generator().manual_seed(1))
    p = {k: v.detach().double().numpy() for k, v in layer.named_parameters()}
    h = cfg.ssm_heads
    assert h == 512
    trunc = 0.8796  # the std of N(0, 1) truncated to [-2, 2]
    for leaf, std in (("in_z", cfg.d_model ** -0.5),
                      ("in_x", cfg.d_model ** -0.5),
                      ("in_bc", cfg.d_model ** -0.5),
                      ("in_dt", cfg.d_model ** -0.5),
                      ("out_proj", cfg.d_inner ** -0.5),
                      ("conv_x_w", cfg.ssm_conv ** -0.5),
                      ("conv_bc_w", cfg.ssm_conv ** -0.5)):
        w = p[leaf]
        assert abs(w.std() / (trunc * std) - 1.0) < 0.05, leaf
        assert np.abs(w).max() <= 2.0 * std * (1 + 1e-6), leaf
        assert abs(w.mean()) < 0.1 * std, leaf
    log_dt = np.log10(np.log1p(np.exp(p["dt_bias"])))
    assert log_dt.min() >= -3.0 - 1e-5 and log_dt.max() <= -1.0 + 1e-5
    q = np.quantile(log_dt, [0.25, 0.5, 0.75])
    np.testing.assert_allclose(q, [-2.5, -2.0, -1.5], atol=0.12)
    np.testing.assert_allclose(p["A_log"], np.log(np.linspace(1, 16, h)),
                               rtol=1e-6)
    np.testing.assert_array_equal(p["D"], np.ones(h))
    np.testing.assert_array_equal(p["norm.scale"], np.ones(cfg.d_inner))


def test_hybrid_refuses_layers_that_do_not_group():
    cfg = dataclasses.replace(configs.get_config("zamba2-2.7b", smoke=True),
                              n_layers=5)
    with pytest.raises(ValueError, match="groups"):
        tlm.init(cfg, device="cpu")


@pytest.mark.parametrize("flash", [False, True])
def test_attention_at_head_dim_80_matches_jax(flash):
    """zamba2-2.7b's heads are 80 wide (not a power of two)."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(2, 24, 4, 80)).astype(np.float32)
               for _ in range(3))
    kw = dict(q_chunk=8, scale=1.0 / np.sqrt(80.0))
    if flash:
        kw["kv_chunk"] = 12
    tf = tattn.flash_causal_attention if flash else \
        tattn.chunked_causal_attention
    jf = jattn.flash_causal_attention if flash else \
        jattn.chunked_causal_attention
    got = tf(*map(torch.as_tensor, (q, k, v)), **kw)
    want = jax.jit(functools.partial(jf, **kw))(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_on_the_cpu(arch, capsys):
    toks = tserve.main(["--arch", arch, "--smoke", "--batch", "2",
                        "--prompt-len", "16", "--steps", "4"], device="cpu")
    vocab = configs.get_config(arch, smoke=True).vocab
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    assert toks.device.type == "cpu"
    assert ((toks >= 0) & (toks < vocab)).all()
    assert "first sequence" in capsys.readouterr().out


def test_lm_embed_over_an_ssm_matches_jax():
    scalars, _ = tds._scalar_table(64, 0)
    _, model = _carried(*_cfgs("mamba2-370m"))
    ref = jaug.lm_embed(scalars, 16, arch="mamba2-370m", smoke=True, seed=0,
                        batch=32)
    got = taug.lm_embed(scalars, 16, seed=0, batch=32, model=model)
    assert got.shape == (64, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5)
    own = taug.lm_embed(scalars, 16, arch="mamba2-370m", seed=0, batch=32,
                        device="cpu")
    np.testing.assert_allclose(np.linalg.norm(own, axis=1), 1.0, atol=1e-5)
