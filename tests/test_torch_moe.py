"""The port's MoE layer, MLA attention and the moe family against JAX.

Parameters are carried across (``jax.tree_util.tree_map(np.asarray, ...)``
of JAX's own init, into ``convert.lm_params`` for a whole model) and the
inputs drawn from one numpy seed, so both packages run the same model:

* ``router_topk`` (ties to the smaller expert id), ``group_capacity`` and
  ``routing_tensors`` (choice 0 claims capacity first, drops past it);
* ``moe_apply``'s y and aux with drops at the default capacity factor,
  with ``moe_group_tokens``, with and without the shared expert, within
  atol and rtol 1e-4 in f32; in bf16 the routing (``top_i``, ``keep``)
  first, then y within ``BF16_TOL``;
* MLA: the expanded ``mla_apply``, the prefill's compressed cache and
  three absorbed ``mla_decode`` steps against JAX; the absorbed decode
  against the port's own expanded form;
* ``deepseek-v3-smoke`` (MLA, MTP) and ``kimi-k2-smoke`` (GQA) end to end
  at the default capacity factor: ``hidden`` and its aux, the prefill's
  logits and every layer's cache, three decode steps (fed JAX's greedy
  tokens) and ``greedy_generate``'s tokens, against one jitted JAX program
  per arch run in a module fixture; at ``capacity_factor=8`` (nothing
  drops, as ``tests/test_models.py`` sets it) prefill + decode equals the
  full forward;
* the port's own init: JAX's leaf names, shapes and laws, MTP included;
  ``param_dtype="bfloat16"`` gives bf16 leaves and an f32 router, and a
  JAX tree in bf16 carries leaf for leaf and runs as JAX's does;
* ``launch.serve.main`` on the CPU for both moe smoke configs.
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
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import lm_serving as jls  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import lm_serving as tls  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

ARCHS = ("deepseek-v3-671b", "kimi-k2-1t-a32b")
B = 2
PROMPT = 32  # two query chunks of the smoke configs' attn_chunk_q=16
DECODE = 3
GREEDY = 6
MAX_LEN = PROMPT + GREEDY + 1
TOL = dict(atol=1e-4, rtol=1e-4)
# bf16 rounds every activation to 8 significant bits, and XLA's CPU
# fusions round in other places than torch's op-by-op casts
# (tests/test_torch_models.py's tolerance)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)


def _cfgs(arch: str, **over) -> tuple:
    j = dataclasses.replace(jconfigs.get_config(arch, smoke=True), **over)
    t = dataclasses.replace(configs.get_config(arch, smoke=True), **over)
    return j, t


def _np(x) -> np.ndarray:
    """A copy in f32 (the port's decode writes its cache in place)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float()
    return np.array(np.asarray(x, np.float32))


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _torch_tree(tree):
    """numpy leaves (f32 or bf16) -> torch tensors of the same dtype."""
    def one(a):
        a = np.asarray(a)
        t = torch.as_tensor(a.astype(np.float32))
        return t.to(torch.bfloat16) if str(a.dtype) == "bfloat16" else t
    return _tree(tree, one)


def _jax_params(fn, *args):
    return jax.tree_util.tree_map(np.asarray, fn(*args))


def _moe_params(cfg, seed: int = 0) -> dict:
    return _jax_params(jmoe.moe_init, jax.random.PRNGKey(seed), cfg)


def _x(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_router_topk_matches_jax_and_breaks_ties_by_id():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 40, 16)).astype(np.float32)
    # exact ties: the same logit for experts 3, 5, 9 and 12 of row 0
    logits[:, 0, [3, 5, 9, 12]] = 4.0
    logits[:, 1] = 0.0  # every expert ties
    w, i, p = tmoe.router_topk(torch.as_tensor(logits), 3)
    jw, ji, jp = jmoe.router_topk(jnp.asarray(logits), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), **TOL)
    assert i[0, 0].tolist() == [3, 5, 9] and i[0, 1].tolist() == [0, 1, 2]
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_group_capacity_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    for cf in (0.3, 1.0, 1.25, 8.0):
        for t in (1, 2, 3, 7, 16, 17, 32, 100, 512):
            j, tc = (dataclasses.replace(c, capacity_factor=cf)
                     for c in (jcfg, tcfg))
            assert tmoe.group_capacity(t, tc) == jmoe.group_capacity(t, j), \
                (cf, t)


@pytest.mark.parametrize("cap_", [2, 5, 12])
def test_routing_tensors_match_jax(cap_):
    """Choice 0 of every token claims capacity before any choice 1; an
    assignment past ``cap`` is dropped."""
    rng = np.random.default_rng(1)
    e, k = 6, 2
    top_i = np.stack([rng.permutation(e)[:k] for _ in range(2 * 20)]
                     ).reshape(2, 20, k).astype(np.int32)
    top_w = rng.uniform(0.1, 1.0, size=(2, 20, k)).astype(np.float32)
    got = tmoe.routing_tensors(torch.as_tensor(top_w),
                               torch.as_tensor(top_i).long(), torch.float32,
                               e, cap_)
    want = jmoe.routing_tensors(jnp.asarray(top_w), jnp.asarray(top_i),
                                jnp.float32, e, cap_)
    for name, g, w in zip(("dispatch", "combine", "keep"), got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL, err_msg=name)
    keep = got[2].numpy()
    assert (keep.mean() < 1.0) == (cap_ < 12)


# ---------------------------------------------------------------------------
# one MoE layer
# ---------------------------------------------------------------------------

MOE_CASES = {
    "drops": {},
    "group_tokens": dict(moe_group_tokens=8),
    "no_shared": dict(n_shared_experts=0),
    "tight": dict(capacity_factor=0.5, moe_group_tokens=16),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_jax(case):
    jcfg, tcfg = _cfgs("deepseek-v3-671b", **MOE_CASES[case])
    p = _moe_params(jcfg, seed=2)
    x = _x(jcfg, 3, 32, seed=3)
    y, aux = tmoe.moe_apply(_torch_tree(p), tcfg, torch.as_tensor(x))
    jy, jaux = jmoe.moe_apply(jax.tree_util.tree_map(jnp.asarray, p), jcfg,
                              jnp.asarray(x))
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(_np(aux[k]), _np(jaux[k]), **TOL,
                                   err_msg=k)
    assert float(aux["moe_drop_frac"]) > 0.0  # the capacity binds
    assert ("shared" in p) == (case != "no_shared")


def test_moe_apply_bf16_routes_as_jax_then_matches():
    """bf16 activations: the router runs in f32 on the same bf16 inputs, so
    the choices and the kept assignments must agree first; y then within
    BF16_TOL."""
    jcfg, tcfg = _cfgs("deepseek-v3-671b", dtype="bfloat16")
    p = _moe_params(jcfg, seed=4)
    x = _x(jcfg, 3, 32, seed=5)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.as_tensor(x).to(torch.bfloat16)
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16), p)
    jp["router"] = jnp.asarray(p["router"])
    tp = _tree(p, lambda a: torch.tensor(a).to(torch.bfloat16))
    tp["router"] = torch.tensor(p["router"])
    _, ti, _ = tmoe.router_topk(tx.float() @ tp["router"],
                                tcfg.n_experts_per_tok)
    _, ji, _ = jmoe.router_topk(jx.astype(jnp.float32) @ jp["router"],
                                jcfg.n_experts_per_tok)
    flips = np.argwhere((ti.numpy() != np.asarray(ji)).any(-1))
    assert flips.size == 0, f"routing differs at (row, token) {flips.tolist()}"
    cap_ = tmoe.group_capacity(32, tcfg)
    _, keep = tmoe.expert_positions(ti, tcfg.n_experts, cap_)
    _, _, jkeep = jmoe.routing_tensors(jnp.ones(ji.shape), ji, jnp.float32,
                                       jcfg.n_experts, cap_)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    y, aux = tmoe.moe_apply(tp, tcfg, tx)
    jy, jaux = jmoe.moe_apply(jp, jcfg, jx)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y), _np(jy), **BF16_TOL)
    np.testing.assert_allclose(_np(aux["moe_drop_frac"]),
                               _np(jaux["moe_drop_frac"]), atol=0)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_pair(seed: int = 6) -> tuple:
    jcfg, tcfg = _cfgs("deepseek-v3-671b")
    p = _jax_params(jattn.mla_init, jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, p


def test_mla_prefill_and_absorbed_decode_match_jax():
    jcfg, tcfg, p = _mla_pair()
    x = _x(jcfg, B, PROMPT + DECODE, seed=7)
    pos = np.tile(np.arange(PROMPT, dtype=np.int32), (B, 1))
    tp, jp = _torch_tree(p), jax.tree_util.tree_map(jnp.asarray, p)
    y = tattn.mla_apply(tp, tcfg, torch.as_tensor(x[:, :PROMPT]),
                        torch.as_tensor(pos))
    jy = jattn.mla_apply(jp, jcfg, jnp.asarray(x[:, :PROMPT]),
                         jnp.asarray(pos))
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    cache = tattn.attn_make_cache(tcfg, B, MAX_LEN, torch.float32, "cpu")
    assert set(cache) == {"c_kv", "k_rope"}
    jcache = jattn.attn_make_cache(jcfg, B, MAX_LEN, jnp.float32)
    yp, cache = tattn.attn_prefill(tp, tcfg, torch.as_tensor(x[:, :PROMPT]),
                                   torch.as_tensor(pos), cache)
    jyp, jcache = jattn.attn_prefill(jp, jcfg, jnp.asarray(x[:, :PROMPT]),
                                     jnp.asarray(pos), jcache)
    np.testing.assert_allclose(_np(yp), _np(jyp), **TOL)
    for i in range(DECODE):
        for k in ("c_kv", "k_rope"):
            np.testing.assert_allclose(_np(cache[k]), _np(jcache[k]), **TOL,
                                       err_msg=f"step {i} {k}")
        xi = x[:, PROMPT + i: PROMPT + i + 1]
        yd, cache = tattn.attn_decode(tp, tcfg, torch.as_tensor(xi),
                                      PROMPT + i, cache)
        jyd, jcache = jattn.attn_decode(jp, jcfg, jnp.asarray(xi),
                                        jnp.asarray(PROMPT + i, jnp.int32),
                                        jcache)
        np.testing.assert_allclose(_np(yd), _np(jyd), **TOL,
                                   err_msg=f"decode step {i}")


def test_mla_absorbed_decode_equals_the_expanded_form():
    _, tcfg, p = _mla_pair(seed=8)
    tp = _torch_tree(p)
    n = PROMPT + 4  # two query chunks of 18
    x = torch.as_tensor(_x(tcfg, B, n, seed=9))
    pos = torch.arange(n, dtype=torch.int32).expand(B, n)
    full = tattn.mla_apply(tp, tcfg, x, pos)
    cache = tattn.mla_make_cache(tcfg, B, n, torch.float32, "cpu")
    _, cache = tattn.mla_prefill(tp, tcfg, x[:, :PROMPT], pos[:, :PROMPT],
                                 cache)
    for i in range(DECODE):
        y, cache = tattn.mla_decode(tp, tcfg, x[:, PROMPT + i: PROMPT + i + 1],
                                    PROMPT + i, cache)
        np.testing.assert_allclose(_np(y[:, 0]), _np(full[:, PROMPT + i]),
                                   atol=1e-5, rtol=1e-4)


def test_gqa_refuses_an_mla_config():
    with pytest.raises(ValueError, match="MLA"):
        tattn.GQA(configs.get_config("deepseek-v3-671b", smoke=True),
                  generator=torch.Generator())


# ---------------------------------------------------------------------------
# the moe family end to end
# ---------------------------------------------------------------------------

def _tokens(cfg, seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, n)).astype(np.int32)


def _jax_run(jcfg):
    """One jitted JAX program: ``hidden`` with its aux, the prefill's
    logits and cache, then ``jls.greedy_generate``'s loop (argmax over the
    real vocab, fed back) for GREEDY steps."""
    prefill = jls.make_prefill_step(jcfg, MAX_LEN)
    decode = jls.make_decode_step(jcfg)

    def greedy(logits):
        return jnp.argmax(logits[..., : jcfg.vocab], axis=-1).astype(
            jnp.int32)

    def run(params, prompt):
        h, aux = jlm.hidden(params, jcfg, prompt)
        logits, cache = prefill(params, prompt)

        def step(carry, i):
            tok, c = carry
            out, c = decode(params, {"token": tok}, PROMPT + i, c)
            return (greedy(out), c), (tok, out)

        _, (fed, outs) = jax.lax.scan(step, (greedy(logits), cache),
                                      jnp.arange(GREEDY, dtype=jnp.int32))
        return h, aux, logits, cache, fed.T, outs

    return jax.jit(run)


@pytest.fixture(scope="module", params=ARCHS)
def jax_side(request):
    jcfg, tcfg = _cfgs(request.param)
    params = _jax_params(jlm.init, jax.random.PRNGKey(0), jcfg)
    model = convert.lm_params(params, tcfg, device="cpu")
    toks = _tokens(jcfg, 0, PROMPT)
    h, aux, logits, cache, fed, outs = _jax_run(jcfg)(
        params, {"tokens": jnp.asarray(toks)})
    ref = dict(hidden=_np(h), aux={k: _np(v) for k, v in aux.items()},
               prefill=_np(logits), cache=_tree(cache, _np),
               greedy=np.array(fed), decode=_np(outs))
    return dict(arch=request.param, cfg=tcfg, model=model, toks=toks,
                params=params, ref=ref)


def test_port_matches_jax(jax_side):
    s = jax_side
    model, ref, cfg = s["model"], s["ref"], s["cfg"]
    tb = {"tokens": torch.as_tensor(s["toks"])}
    h, aux = tlm.hidden(model, tb, with_aux=True)
    np.testing.assert_allclose(_np(h), ref["hidden"], **TOL)
    assert set(aux) == set(tlm.AUX_KEYS) == set(ref["aux"])
    for k in aux:
        np.testing.assert_allclose(_np(aux[k]), ref["aux"][k], **TOL,
                                   err_msg=k)
    assert float(aux["moe_drop_frac"]) > 0.0  # the prompt drops tokens
    logits, cache = tlm.prefill(model, tb, MAX_LEN)
    np.testing.assert_allclose(_np(logits), ref["prefill"], **TOL)
    for step in range(DECODE):
        if step == 0:
            got = _tree(cache, _np)
            assert set(got) == set(ref["cache"]) == {"dense", "moe"}
            for kind, c in got.items():
                for name, v in c.items():
                    want = ref["cache"][kind][name]
                    assert v.shape == want.shape, (kind, name)
                    assert v.shape[0] == (cfg.first_k_dense if kind == "dense"
                                          else cfg.n_layers - cfg.first_k_dense)
                    np.testing.assert_allclose(
                        v, want, **TOL, err_msg=f"{s['arch']} {kind} {name}")
        tok = torch.as_tensor(ref["greedy"][:, step])
        logits, cache = tlm.decode_step(model, {"token": tok}, PROMPT + step,
                                        cache)
        np.testing.assert_allclose(_np(logits), ref["decode"][step], **TOL,
                                   err_msg=f"{s['arch']} decode step {step}")


def test_greedy_generate_matches_jax(jax_side):
    s = jax_side
    toks = tls.greedy_generate(s["model"],
                               {"tokens": torch.as_tensor(s["toks"])},
                               steps=GREEDY, max_len=MAX_LEN)
    assert toks.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(), s["ref"]["greedy"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_without_drops(arch):
    """``tests/test_models.py``'s property at ``capacity_factor=8``:
    prefill + decode steps give the full forward's logits."""
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              capacity_factor=8.0)
    model = tlm.init(cfg, seed=0, device="cpu")
    toks = torch.as_tensor(_tokens(cfg, 5, 16))
    h, aux = tlm.hidden(model, {"tokens": toks}, with_aux=True)
    assert float(aux["moe_drop_frac"]) == 0.0
    logits, cache = tlm.prefill(model, {"tokens": toks[:, :12]}, 16)
    full = tlm.unembed(model, h)
    np.testing.assert_allclose(_np(logits), _np(full[:, 11]),
                               atol=2e-2, rtol=2e-3)
    for i in range(12, 15):
        logits, cache = tlm.decode_step(model, {"token": toks[:, i]}, i,
                                        cache)
        np.testing.assert_allclose(_np(logits), _np(full[:, i]),
                                   atol=2e-2, rtol=2e-3)


def _routes_np(top_i, keep) -> np.ndarray:
    """(B, S, k) choices and keep flags as one (B, S, 2k) int array."""
    return np.concatenate([np.asarray(top_i, np.int64),
                           np.asarray(keep, np.int64)], axis=-1)


def _port_routes(monkeypatch) -> list:
    """Record each MoE block's routing (its choices and keep flags, on
    the normed input the block routes) as the port's forward runs."""
    routes = []
    real = tlm._moe_dispatch

    def rec(p, cfg, h):
        _, top_i, _ = tmoe.router_topk(h.float() @ p["router"],
                                       cfg.n_experts_per_tok)
        _, keep = tmoe.expert_positions(
            top_i, cfg.n_experts, tmoe.group_capacity(h.shape[1], cfg))
        routes.append(_routes_np(top_i, keep))
        return real(p, cfg, h)

    monkeypatch.setattr(tlm, "_moe_dispatch", rec)
    return routes


def _jax_routes(monkeypatch) -> list:
    """The same record from inside JAX's jitted forward (a host callback,
    in block order)."""
    routes = []
    real = jlm.moe_apply

    def rec(p, cfg, h):
        logits = jnp.einsum("bsd,de->bse", h.astype(jnp.float32),
                            p["router"])
        _, top_i, _ = jmoe.router_topk(logits, cfg.n_experts_per_tok)
        _, _, keep = jmoe.routing_tensors(
            jnp.ones(top_i.shape), top_i, jnp.float32, cfg.n_experts,
            jmoe.group_capacity(h.shape[1], cfg))
        jax.debug.callback(lambda i, k: routes.append(_routes_np(i, k)),
                           top_i, keep, ordered=True)
        return real(p, cfg, h)

    monkeypatch.setattr(jlm, "moe_apply", rec)
    return routes


def _held_before_flips(monkeypatch, jcfg, params, model, toks, label):
    """The two packages' bf16 forwards, routing compared first: in each
    row, the positions before the first token that any MoE block routes
    otherwise (a near-tie of the router's top-k, or a queue slot past
    capacity, that bf16 rounding decides differently) are held within
    BF16_TOL; a routing difference touches only later positions (causal
    attention, queues filled in sequence order). The tokens routed
    otherwise are printed. -> their (block, row, position)s."""
    assert not jcfg.moe_group_tokens
    batch = {"tokens": torch.as_tensor(toks)}
    t_routes, j_routes = _port_routes(monkeypatch), _jax_routes(monkeypatch)
    h = tlm.hidden(model, batch)
    jh, _ = jax.jit(lambda p, b: jlm.hidden(p, jcfg, b))(
        params, {"tokens": jnp.asarray(toks)})
    jax.effects_barrier()
    assert len(t_routes) == len(j_routes) == \
        jcfg.n_layers - jcfg.first_k_dense
    flips = [(blk, int(r), int(t)) for blk, (a, b) in
             enumerate(zip(t_routes, j_routes))
             for r, t in np.argwhere((a != b).any(-1))]
    print(f"{label}: tokens routed otherwise (block, row, position): "
          f"{flips or 'none'}")
    first = np.full(toks.shape[0], toks.shape[1])
    for _, r, t in flips:
        first[r] = min(first[r], t)
    assert first.min() > 0, f"{label}: the first token routes otherwise"
    for r in range(toks.shape[0]):
        np.testing.assert_allclose(_np(h[r, : first[r]]),
                                   _np(jh[r, : first[r]]), **BF16_TOL,
                                   err_msg=f"{label} row {r}")
    return flips


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_blocks_on_jax_activations_route_and_match(arch):
    """bf16 activations on f32 parameters (``_cast_block``), block by
    block on JAX's own activations: each block's attention half within
    BF16_TOL; each MoE block routes JAX's normed input exactly as JAX
    does (choices and keep flags), then its FFN output within BF16_TOL."""
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    params = _jax_params(jlm.init, jax.random.PRNGKey(1), jcfg)
    model = convert.lm_params(params, tcfg, device="cpu")
    toks = _tokens(jcfg, 3, PROMPT)
    x, pos = jlm.embed_inputs(params, jcfg, {"tokens": jnp.asarray(toks)})
    tx, tpos = tlm.embed_inputs(model, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_array_equal(_np(tx), _np(x))
    for stack in tlm._stacks(model):
        for i, blk in enumerate(getattr(model, stack)):
            label = f"{arch} {stack} {i}"
            jbp = jlm._cast_block(jax.tree_util.tree_map(
                lambda a, i=i: jnp.asarray(a[i]), params[stack]), jcfg)
            tbp = tlm.param_tree(blk, torch.bfloat16)
            xn = jlm.norm_apply(jcfg, jbp["norm1"], x)
            ja = jattn.attn_apply(jbp["attn"], jcfg, xn, pos)
            ta = tattn.attn_apply(tbp["attn"], tcfg, _torch_tree(np.asarray(
                xn)), tpos)
            assert ta.dtype == torch.bfloat16
            np.testing.assert_allclose(_np(ta), _np(ja), **BF16_TOL,
                                       err_msg=f"{label} attention")
            x = x + ja
            h = jlm.norm_apply(jcfg, jbp["norm2"], x)
            th = _torch_tree(np.asarray(h))
            if stack == "moe_blocks":
                jy, _ = jmoe.moe_apply(jbp["moe"], jcfg, h)
                ty, _ = tmoe.moe_apply(tbp["moe"], tcfg, th)
                cap_ = tmoe.group_capacity(PROMPT, tcfg)
                _, ti, _ = tmoe.router_topk(th.float() @ tbp["moe"]["router"],
                                            tcfg.n_experts_per_tok)
                _, keep = tmoe.expert_positions(ti, tcfg.n_experts, cap_)
                _, ji, _ = jmoe.router_topk(
                    h.astype(jnp.float32) @ jbp["moe"]["router"],
                    jcfg.n_experts_per_tok)
                _, _, jkeep = jmoe.routing_tensors(
                    jnp.ones(ji.shape), ji, jnp.float32, jcfg.n_experts, cap_)
                np.testing.assert_array_equal(
                    _routes_np(ti, keep), _routes_np(ji, jkeep),
                    err_msg=f"{label} routing")
            else:
                jy = jlm.ffn_apply(jbp["ffn"], h, jcfg.ffn_act)
                ty = tlm.ffn_apply(tbp["ffn"], th, tcfg.ffn_act)
            np.testing.assert_allclose(_np(ty), _np(jy), **BF16_TOL,
                                       err_msg=f"{label} ffn")
            x = x + jy


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_held_before_routing_differs(arch, monkeypatch):
    """The whole bf16 forward of each package on its own activations:
    ``_held_before_flips``."""
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    params = _jax_params(jlm.init, jax.random.PRNGKey(1), jcfg)
    model = convert.lm_params(params, tcfg, device="cpu")
    _held_before_flips(monkeypatch, jcfg, params, model,
                       _tokens(jcfg, 3, PROMPT), f"{arch} bf16")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_own_init_has_jax_names_shapes_and_laws(arch):
    jcfg, tcfg = _cfgs(arch)
    params = _jax_params(jlm.init, jax.random.PRNGKey(0), jcfg)
    model = tlm.init(tcfg, seed=0, device="cpu")
    named = dict(model.named_parameters())
    assert set(named) == convert.lm_names(params)
    assert any(n.startswith("mtp.") for n in named) == bool(tcfg.mtp_depth)
    for name, t in named.items():
        ref = convert.lm_leaf(params, name)
        got = t.detach().numpy()
        assert got.shape == ref.shape and got.dtype == np.float32, name
        if "norm" in name:  # ones
            np.testing.assert_array_equal(got, ref, err_msg=name)
            continue
        parts = name.split(".")
        if parts[0] in ("dense_blocks", "moe_blocks"):  # the whole stack
            node = params[parts[0]]
            for k in parts[2:]:
                node = node[k]
            ref = np.asarray(node)
        assert abs(got.std() / ref.std() - 1.0) < 0.10, name


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_parameters_carry_and_run_as_jax(arch, monkeypatch):
    """``param_dtype="bfloat16"``: the port's own init gives bf16 leaves
    and an f32 router; JAX's bf16 tree carries leaf for leaf (an f32 tree
    into a bf16 model is refused) and its forward and prefill match
    JAX's."""
    jcfg, tcfg = _cfgs(arch, param_dtype="bfloat16", dtype="bfloat16")
    own = tlm.init(tcfg, device="cpu")
    for name, t in own.named_parameters():
        want = torch.float32 if name.endswith(".router") else torch.bfloat16
        assert t.dtype == want, name
    cast = tlm.cast_blocks(own)
    assert cast["moe_blocks"][0]["moe"]["w_up"] is own.moe_blocks[0].moe.w_up
    params = _jax_params(jlm.init, jax.random.PRNGKey(2), jcfg)
    assert str(params["moe_blocks"]["moe"]["w_up"].dtype) == "bfloat16"
    assert params["moe_blocks"]["moe"]["router"].dtype == np.float32
    model = convert.lm_params(params, tcfg, device="cpu")
    for name, t in model.named_parameters():
        np.testing.assert_array_equal(
            t.detach().float().numpy(),
            convert.lm_leaf(params, name).astype(np.float32), err_msg=name)
    f32 = _jax_params(jlm.init, jax.random.PRNGKey(2),
                      dataclasses.replace(jcfg, param_dtype="float32"))
    with pytest.raises(ValueError, match="float32"):
        convert.lm_params(f32, tcfg, device="cpu")
    _held_before_flips(monkeypatch, jcfg, params, model,
                       _tokens(jcfg, 4, PROMPT), f"{arch} bf16 parameters")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_on_the_cpu(arch, capsys):
    toks = tserve.main(["--arch", arch, "--smoke", "--batch", "2",
                        "--prompt-len", "16", "--steps", "4"], device="cpu")
    vocab = configs.get_config(arch, smoke=True).vocab
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    assert ((toks >= 0) & (toks < vocab)).all()
    assert "first sequence" in capsys.readouterr().out
