"""MHQ Rewriter: predicted execution strategies and parameters (paper §3.4).

Port of ``repro.core.rewriter``. Phase 1 — strategy head over
``STRATEGIES`` (four-way; graph plans legalize to ``index_scan`` while the
graph tier is unbound). Phase 2 — per-column classification heads over the
nprobe / max_scan / k_mult grids plus a Bernoulli iterative_scan head, a
precision head and the graph beam/hop head.

Labels are self-supervised: execute each workload query under a grid of
candidate configurations, measure (latency, recall) and pick the cheapest
configuration that meets the query's recall target plus a margin. The
latency is wall-clock by default (``HybridExecutor.execute_timed``);
``work_timer`` gives a deterministic cost instead, the elements a plan
reads (``plan_work``), so a fit does not move with the host's load.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch
from torch import nn

from repro_torch.common.nn import MLP
from repro_torch.core.executor import (
    HybridExecutor, plan_columns, recall_at_k,
)
from repro_torch.core.query import (
    BEAM_GRID, ExecutionPlan, HOP_GRID, KMULT_GRID, MAX_SCAN_GRID, MHQ,
    NPROBE_GRID, PRECISION_GRID, STRATEGIES, SubqueryParams,
)
from repro_torch.kernels.shapes import GRAPH_ENTRY_POINTS, GRAPH_SEED_FACTOR
from repro_torch.train import optimizer
from repro_torch.vectordb import ivf, predicates
from repro_torch.train.optimizer import AdamWConfig

N_NP, N_MS, N_KM = len(NPROBE_GRID), len(MAX_SCAN_GRID), len(KMULT_GRID)
N_BEAM, N_HOP = len(BEAM_GRID), len(HOP_GRID)
PER_COL = N_NP + N_MS + N_KM + 1


@dataclasses.dataclass(frozen=True)
class RewriterConfig:
    hidden: int = 96
    lr: float = 2e-3
    steps: int = 800
    batch: int = 64
    seed: int = 0
    refine_columns: bool = True  # per-column greedy trim of the best plan


@dataclasses.dataclass
class PlanLabel:
    strategy: int
    nprobe_idx: np.ndarray  # (N,)
    max_scan_idx: np.ndarray  # (N,)
    k_mult_idx: np.ndarray  # (N,)
    iterative: np.ndarray  # (N,) {0,1}
    latency: float
    recall: float
    precision: int = 0
    beam_idx: int = 1
    hop_idx: int = 1


class MHQRewriter(nn.Module):
    """Trunk + five heads (strategy, per-column knobs, precision, graph)."""

    def __init__(self, in_dim: int, n_vec: int, cfg: RewriterConfig, *,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.n_vec = n_vec
        self.in_dim = in_dim
        gen = torch.Generator().manual_seed(cfg.seed)
        h = cfg.hidden
        self.trunk = MLP([in_dim, h, h], generator=gen)
        self.strategy = MLP([h, len(STRATEGIES)], generator=gen)
        self.per_col = MLP([h, n_vec * PER_COL], generator=gen)
        self.precision = MLP([h, len(PRECISION_GRID)], generator=gen)
        self.graph = MLP([h, N_BEAM + N_HOP], generator=gen)
        if device is not None:
            self.to(device)

    def heads(self, x: torch.Tensor):
        z = self.trunk(x, final_activation=True)
        per_col = self.per_col(z)
        per_col = per_col.reshape(*per_col.shape[:-1], self.n_vec, PER_COL)
        return self.strategy(z), per_col, self.precision(z), self.graph(z)

    @torch.no_grad()
    def plan_codes(self, x: torch.Tensor) -> torch.Tensor:
        """(B, F) -> (B, codes) int32 [strategy, np_idx×N, ms_idx×N,
        km_idx×N, iter×N, precision, beam_idx, hop_idx] (argmax takes the
        first maximum, like ``jnp.argmax``)."""
        strat, per_col, prec, gr = self.heads(x)
        s_idx = torch.argmax(strat, dim=-1)[:, None]
        np_i = torch.argmax(per_col[..., :N_NP], dim=-1)
        ms_i = torch.argmax(per_col[..., N_NP:N_NP + N_MS], dim=-1)
        km_i = torch.argmax(per_col[..., N_NP + N_MS:N_NP + N_MS + N_KM],
                            dim=-1)
        it = (per_col[..., -1] > 0.0).to(torch.int64)
        p_idx = torch.argmax(prec, dim=-1)[:, None]
        b_idx = torch.argmax(gr[..., :N_BEAM], dim=-1)[:, None]
        h_idx = torch.argmax(gr[..., N_BEAM:], dim=-1)[:, None]
        return torch.cat([s_idx, np_i, ms_i, km_i, it, p_idx, b_idx, h_idx],
                         dim=-1).to(torch.int32)

    def plan_from_codes(self, codes: np.ndarray) -> ExecutionPlan:
        n = self.n_vec
        s_idx = int(codes[0])
        np_i, ms_i, km_i = (codes[1:1 + n], codes[1 + n:1 + 2 * n],
                            codes[1 + 2 * n:1 + 3 * n])
        it = codes[1 + 3 * n:1 + 4 * n]
        prec = PRECISION_GRID[int(codes[1 + 4 * n])] \
            if codes.shape[0] > 1 + 4 * n else "fp32"
        beam = BEAM_GRID[int(codes[2 + 4 * n])] \
            if codes.shape[0] > 2 + 4 * n else ExecutionPlan.beam_width
        hops = HOP_GRID[int(codes[3 + 4 * n])] \
            if codes.shape[0] > 3 + 4 * n else ExecutionPlan.n_hops
        subs = tuple(
            SubqueryParams(k_mult=KMULT_GRID[km_i[i]],
                           nprobe=NPROBE_GRID[np_i[i]],
                           max_scan=MAX_SCAN_GRID[ms_i[i]],
                           iterative=bool(it[i]))
            for i in range(n))
        return ExecutionPlan(strategy=STRATEGIES[s_idx], subqueries=subs,
                             precision=prec, beam_width=beam, n_hops=hops)

    def predict(self, x: np.ndarray, *, k: int = 10) -> ExecutionPlan:
        """Single-query convenience wrapper over the canonical decode path
        (``plan_codes`` -> ``plan_from_codes``), so the two cannot drift.
        x: (F,) features. The caller picks the dominant column for
        ``single_index``."""
        dev = self.trunk.layers[0].w.device
        xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return self.plan_from_codes(self.plan_codes(xt[None])[0].cpu().numpy())

    # -- training --------------------------------------------------------------

    def fit(self, X: np.ndarray, labels: list) -> dict:
        cfg = self.cfg
        dev = self.trunk.layers[0].w.device
        n = X.shape[0]

        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        y_strat = t([lb.strategy for lb in labels])
        y_np = t(np.stack([lb.nprobe_idx for lb in labels]))
        y_ms = t(np.stack([lb.max_scan_idx for lb in labels]))
        y_km = t(np.stack([lb.k_mult_idx for lb in labels]))
        y_it = t(np.stack([lb.iterative for lb in labels]), torch.float32)
        y_prec = t([lb.precision for lb in labels])
        y_beam = t([lb.beam_idx for lb in labels])
        y_hop = t([lb.hop_idx for lb in labels])
        par_mask = t([1.0 if lb.strategy != 0 else 0.0 for lb in labels],
                     torch.float32)
        gr_idx = STRATEGIES.index("graph")
        gr_mask = t([1.0 if lb.strategy == gr_idx else 0.0 for lb in labels],
                    torch.float32)
        Xt = t(X, torch.float32)

        def nll(logits, y):
            return -torch.log_softmax(logits, dim=-1).gather(
                -1, y[..., None])[..., 0]

        def loss_fn(idx):
            strat, per_col, prec, gr = self.heads(Xt[idx])
            pm, gm = par_mask[idx], gr_mask[idx]
            ls = nll(strat, y_strat[idx]).mean()
            lprec = (nll(prec, y_prec[idx]) * pm).mean()
            lgr = ((nll(gr[..., :N_BEAM], y_beam[idx])
                    + nll(gr[..., N_BEAM:], y_hop[idx])) * gm).mean()

            def head_ce(sl, y):
                return (nll(per_col[..., sl], y[idx]) * pm[:, None]).mean()

            lp = head_ce(slice(0, N_NP), y_np)
            lp = lp + head_ce(slice(N_NP, N_NP + N_MS), y_ms)
            lp = lp + head_ce(slice(N_NP + N_MS, N_NP + N_MS + N_KM), y_km)
            logit_it = per_col[..., -1]
            bce = ((nn.functional.softplus(logit_it) - y_it[idx] * logit_it)
                   * pm[:, None]).mean()
            return ls + lprec + lgr + lp + bce

        opt_cfg = AdamWConfig(lr=cfg.lr, weight_decay=1e-4, grad_clip_norm=1.0)
        opt = optimizer.make_adamw(self.parameters(), opt_cfg)
        rng = np.random.default_rng(cfg.seed)
        loss = torch.zeros(())
        for _ in range(cfg.steps):
            idx = t(rng.integers(0, n, min(cfg.batch, n)))
            loss = loss_fn(idx)
            optimizer.step(opt, loss, opt_cfg)
        with torch.no_grad():
            strat = self.heads(Xt)[0]
            acc = float((torch.argmax(strat, -1) == y_strat).float().mean())
        return {"rewriter_loss": float(loss.detach()), "strategy_acc": acc}


# ---------------------------------------------------------------------------
# self-supervised label generation (grid execution)
# ---------------------------------------------------------------------------

def candidate_plans(n_vec: int, weights=None, *,
                    graphs: bool = False) -> list:
    """The exploration grid (coarse; the per-column trim refines it)."""
    plans = [ExecutionPlan("filter_first",
                           tuple(SubqueryParams() for _ in range(n_vec)))]
    for npb, km, ms in itertools.product((2, 8, 32), (2, 8), (8192, 131072)):
        subs = tuple(SubqueryParams(k_mult=km, nprobe=npb, max_scan=ms,
                                    iterative=True) for _ in range(n_vec))
        plans.append(ExecutionPlan("index_scan", subs))
    if graphs:
        for bw, nh, km in ((4, 2, 2), (8, 4, 2), (8, 4, 8), (16, 8, 8)):
            subs = tuple(SubqueryParams(k_mult=km, iterative=False)
                         for _ in range(n_vec))
            plans.append(ExecutionPlan("graph", subs, beam_width=bw,
                                       n_hops=nh))
    # quantized-tier twins of the deep-scan configs
    for npb, km in itertools.product((8, 32), (2, 8)):
        subs = tuple(SubqueryParams(k_mult=km, nprobe=npb, max_scan=131072,
                                    iterative=True) for _ in range(n_vec))
        plans.append(ExecutionPlan("index_scan", subs, precision="int8"))
    if n_vec > 1 and weights is not None:
        dom = int(np.argmax(weights))
        for npb in (8, 32):
            subs = tuple(SubqueryParams(k_mult=8, nprobe=npb, max_scan=32768,
                                        iterative=True) for _ in range(n_vec))
            plans.append(ExecutionPlan("single_index", subs, dominant=dom))
    return plans


def _grid_index(grid, value) -> int:
    return min(range(len(grid)), key=lambda i: abs(grid[i] - value))


def plan_to_label(plan: ExecutionPlan, latency: float, recall: float
                  ) -> PlanLabel:
    return PlanLabel(
        strategy=STRATEGIES.index(plan.strategy),
        nprobe_idx=np.asarray([_grid_index(NPROBE_GRID, s.nprobe)
                               for s in plan.subqueries]),
        max_scan_idx=np.asarray([_grid_index(MAX_SCAN_GRID, s.max_scan)
                                 for s in plan.subqueries]),
        k_mult_idx=np.asarray([_grid_index(KMULT_GRID, s.k_mult)
                               for s in plan.subqueries]),
        iterative=np.asarray([1.0 if s.iterative else 0.0
                              for s in plan.subqueries], np.float32),
        latency=latency, recall=recall,
        precision=PRECISION_GRID.index(plan.precision),
        beam_idx=_grid_index(BEAM_GRID, plan.beam_width),
        hop_idx=_grid_index(HOP_GRID, plan.n_hops))


LABEL_RECALL_MARGIN = 0.05  # labels aim slightly above E_rec


def plan_work(executor: HybridExecutor, q: MHQ, plan: ExecutionPlan
              ) -> float:
    """The values the sequential executor's static-shape program reads for
    one plan and query (a vector element or a scalar counts one, at any
    precision): filter_first evaluates every row's scalars and scores its
    ``max_candidates`` slots over every column; each round of an IVF
    subquery scores the column's centroids and the vector and scalars of
    its ``max_scan`` slots (and at int8 reranks the survivors), with
    iterative re-expansion counted round by round; a graph subquery reads
    the vector and scalars of every row its walk may visit; the rerank
    scores the union's slots over every column."""
    from repro_torch.core.executor import rrf_union_total, subquery_width
    from repro_torch.kernels.gather_score import RERANK_MULT
    from repro_torch.kernels.shapes import MAX_TOPK

    plan = executor.legalize(plan)
    t = executor.table
    n, m = t.n_rows, t.schema.n_scalar
    dims = [int(v.shape[1]) for v in t.vectors]
    if plan.strategy == "filter_first":
        return float(n * m + plan.max_candidates * sum(dims))
    cols = plan_columns(q, plan)
    work = union = 0
    for i in cols:
        sp = plan.subqueries[i]
        k_i = min(sp.k_mult * q.k, n)
        union += k_i
        if plan.strategy == "graph":
            visited = GRAPH_ENTRY_POINTS + GRAPH_SEED_FACTOR * plan.beam_width \
                + plan.n_hops * plan.beam_width * executor.graphs[i].degree
            work += min(visited, n) * (dims[i] + m)
            continue
        index = executor.indexes[i]
        cap = min(index.n_clusters, executor.engine.nprobe_cap)
        max_scan = min(sp.max_scan, n)
        kw = subquery_width(k_i, max_scan) if len(cols) > 1 else k_i
        nprobe = sp.nprobe
        while True:
            nprobe = min(nprobe, cap)
            work += index.n_clusters * dims[i] + max_scan * (dims[i] + m)
            if plan.precision == "int8":
                work += max(kw, min(RERANK_MULT * kw, MAX_TOPK)) * dims[i]
            if not sp.iterative:
                break
            rows, valid = ivf.probe_slots(index, q.query_vectors[i],
                                          nprobe=nprobe, max_scan=max_scan)
            n_qual = int((predicates.eval_mask(q.predicates, t.scalars[rows])
                          & valid).sum())
            if n_qual >= k_i or nprobe >= cap:
                break
            nprobe *= 2
    if len(cols) > 1:
        union = rrf_union_total(union)
    return float(work + union * sum(dims))


def wall_timer(executor: HybridExecutor, q: MHQ, plan: ExecutionPlan):
    """-> (ids, scores, seconds): the plan's measured wall-clock time."""
    return executor.execute_timed(q, plan)


def work_timer(executor: HybridExecutor, q: MHQ, plan: ExecutionPlan):
    """-> (ids, scores, ``plan_work``): a deterministic label cost."""
    ids, scores = executor.execute(q, plan)
    return ids.cpu().numpy(), scores.cpu().numpy(), \
        plan_work(executor, q, plan)


def generate_label(executor: HybridExecutor, q: MHQ, gt_ids,
                   *, refine_columns: bool = True,
                   timer=wall_timer) -> PlanLabel:
    """Execute the candidate grid; label = cheapest plan meeting the target
    (+ margin), else the highest-recall plan. Then, for multi-column plans,
    greedily trim each column's k_mult / nprobe while the target holds.
    ``timer(executor, q, plan)`` -> (ids, scores, cost) prices each plan."""
    target = min(1.0, q.recall_target + LABEL_RECALL_MARGIN)
    best, best_any = None, None
    has_graphs = getattr(executor, "graphs", None) is not None
    for plan in candidate_plans(q.n_vec, q.weights, graphs=has_graphs):
        ids, _, dt = timer(executor, q, plan)
        rec = recall_at_k(ids, gt_ids)
        entry = (dt, rec, plan)
        if best_any is None or rec > best_any[1] + 1e-9 or \
                (abs(rec - best_any[1]) < 1e-9 and dt < best_any[0]):
            best_any = entry
        if rec >= target and (best is None or dt < best[0]):
            best = entry
    if best is None:
        best = best_any
    dt, rec, plan = best

    if refine_columns and plan.strategy != "filter_first" and q.n_vec > 1:
        attrs = (("k_mult", KMULT_GRID),) if plan.strategy == "graph" else \
            (("k_mult", KMULT_GRID), ("nprobe", NPROBE_GRID))
        subs = list(plan.subqueries)
        for i in range(q.n_vec):
            for attr, grid in attrs:
                while True:
                    gi = _grid_index(grid, getattr(subs[i], attr))
                    if gi == 0:
                        break
                    trial = dataclasses.replace(subs[i],
                                                **{attr: grid[gi - 1]})
                    trial_plan = dataclasses.replace(
                        plan, subqueries=tuple(subs[:i] + [trial]
                                               + subs[i + 1:]))
                    ids, _, dt_t = timer(executor, q, trial_plan)
                    if recall_at_k(ids, gt_ids) >= target:
                        subs[i] = trial
                        plan, dt, rec = trial_plan, dt_t, recall_at_k(
                            ids, gt_ids)
                    else:
                        break
        plan = dataclasses.replace(plan, subqueries=tuple(subs))

    return plan_to_label(plan, dt, rec)
