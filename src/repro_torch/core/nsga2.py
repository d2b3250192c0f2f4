"""NSGA-II multi-objective evolutionary optimizer (Deb et al. 2002), a copy
of ``repro/core/nsga2.py`` (numpy only; tests pin identical fronts).

Vectorised implementation specialised for discrete layer->device
chromosomes.  All population-level operators (dominance matrix,
front peeling, crowding distance, tournament, crossover, mutation)
are O(N^2·M) numpy array ops — no Python-level per-individual loops in
the hot path.  Fitness evaluation is delegated to a user callback which
may itself batch the whole population onto the card.

Supports Deb's constrained-dominance rules: feasible individuals
dominate infeasible ones; among infeasible, smaller violation wins.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.trace import span

__all__ = ["NSGA2Config", "NSGA2Result", "nsga2", "nsga2_steps",
           "fast_non_dominated_sort", "crowding_distance", "pareto_mask"]


@dataclasses.dataclass(frozen=True)
class NSGA2Config:
    population: int = 60           # paper Sec. VI-A: pop 60
    generations: int = 60          # paper Sec. VI-A: 60 generations
    crossover_rate: float = 0.9
    mutation_rate: float = 0.08    # per-gene
    tournament_k: int = 2
    seed: int = 0


@dataclasses.dataclass
class NSGA2Result:
    pareto_pop: np.ndarray        # [F, L] chromosomes on the final front
    pareto_objs: np.ndarray       # [F, M]
    history: list                 # per-generation best objective vector
    evaluations: int


def _dominance_matrix(F: np.ndarray, violation: np.ndarray | None) -> np.ndarray:
    """dom[i, j] == True iff i constrained-dominates j (minimisation)."""
    le = (F[:, None, :] <= F[None, :, :]).all(axis=2)
    lt = (F[:, None, :] < F[None, :, :]).any(axis=2)
    dom = le & lt
    if violation is not None:
        feas = violation <= 0.0
        both_infeas = ~feas[:, None] & ~feas[None, :]
        # feasible dominates infeasible
        dom = np.where(feas[:, None] & ~feas[None, :], True, dom)
        dom = np.where(~feas[:, None] & feas[None, :], False, dom)
        # among infeasible: strictly smaller violation dominates
        dom = np.where(both_infeas,
                       violation[:, None] < violation[None, :], dom)
    np.fill_diagonal(dom, False)
    return dom


def fast_non_dominated_sort(F: np.ndarray,
                            violation: np.ndarray | None = None) -> np.ndarray:
    """Returns rank[i] (0 = first/best front)."""
    n = F.shape[0]
    dom = _dominance_matrix(F, violation)
    n_dominators = dom.sum(axis=0)       # how many dominate i
    ranks = np.full(n, -1, dtype=np.int64)
    current = np.where(n_dominators == 0)[0]
    r = 0
    remaining = n_dominators.astype(np.int64).copy()
    while current.size:
        ranks[current] = r
        # removing `current` decrements dominator counts of their dominatees
        dec = dom[current].sum(axis=0)
        remaining = remaining - dec
        remaining[current] = -1          # never reselected
        current = np.where(remaining == 0)[0]
        r += 1
    return ranks


def crowding_distance(F: np.ndarray, ranks: np.ndarray) -> np.ndarray:
    """Per-individual crowding distance within its front.

    Vectorised over fronts AND objectives: two stacked stable argsorts
    order every objective column with rows grouped by front (the
    front-segmented prefix trick — sorting by value first, then stably
    by rank, equals a per-front stable value sort), after which spans,
    boundary masks and neighbour differences are computed for all
    fronts in one shot.  Bit-identical to the per-front reference
    implementation: the same ``(f[i+1] - f[i-1]) / span`` operands
    accumulate in the same per-objective order
    (tests/test_nsga2.py::test_crowding_distance_matches_reference).
    """
    n, m = F.shape
    dist = np.zeros(n)
    if n == 0:
        return dist
    o1 = np.argsort(F, axis=0, kind="stable")           # value order [n, m]
    o2 = np.argsort(ranks[o1], axis=0, kind="stable")   # group by front
    order = np.take_along_axis(o1, o2, axis=0)          # [n, m]
    fs = np.take_along_axis(F, order, axis=0)           # sorted values
    rsorted = ranks[order[:, 0]]         # ascending; identical per column
    first = np.empty(n, bool)
    first[0] = True
    first[1:] = rsorted[1:] != rsorted[:-1]
    last = np.empty(n, bool)
    last[-1] = True
    last[:-1] = first[1:]
    starts = np.flatnonzero(first)
    sizes = np.diff(np.append(starts, n))
    fid = np.cumsum(first) - 1                          # front id / position
    span = fs[np.flatnonzero(last)][fid] - fs[starts][fid]      # [n, m]
    small = (sizes <= 2)[fid]            # fronts of <= 2 members: all inf
    contrib = np.zeros((n, m))
    contrib[1:-1] = fs[2:] - fs[:-2]     # valid exactly on interior rows
    interior = (~(first | last | small))[:, None] & (span > 0)
    # objective-major accumulation preserves the reference's += order
    # (each member receives its objective contributions k = 0..m-1)
    np.add.at(dist, order.T[interior.T],
              (contrib / np.where(span > 0, span, 1.0)).T[interior.T])
    boundary = (first | last | small)
    dist[order[boundary].ravel()] = np.inf
    return dist


def pareto_mask(F: np.ndarray) -> np.ndarray:
    """Boolean mask of non-dominated rows of F."""
    return fast_non_dominated_sort(F) == 0


def _tournament(rng, ranks, crowd, k, n_pick):
    """k-way tournament on the exact (rank asc, crowding desc) order.

    The historical scalarised key ``ranks * 1e9 - min(crowd, 1e8)`` was
    only approximately lexicographic: it saturated crowding at 1e8
    (every distance above the cap tied) and, worse, float64 has ~1e-7
    absolute resolution at the 1e9 rank scale, so sub-1e-7 crowding
    differences between same-rank candidates vanished entirely.  A
    stable lexsort compares the two components exactly; ties still
    resolve to the first-drawn candidate, matching argmin semantics
    (tests/test_nsga2.py::test_tournament_exact_lexicographic).
    """
    n = ranks.shape[0]
    cand = rng.integers(0, n, size=(n_pick, k))
    order = np.lexsort((-crowd[cand], ranks[cand]), axis=-1)
    return cand[np.arange(n_pick), order[..., 0]]


def _crossover(rng, parents_a, parents_b, rate):
    """Uniform crossover on integer chromosomes."""
    n, L = parents_a.shape
    do = rng.random(n) < rate
    mask = rng.random((n, L)) < 0.5
    child = np.where(mask, parents_a, parents_b)
    return np.where(do[:, None], child, parents_a)


def _mutate(rng, pop, n_devices, rate):
    n, L = pop.shape
    mask = rng.random((n, L)) < rate
    rand = rng.integers(0, n_devices, size=(n, L))
    return np.where(mask, rand, pop)


def nsga2_steps(eval_fn: Callable[[np.ndarray], np.ndarray],
                n_genes: int, n_devices: int,
                config: NSGA2Config = NSGA2Config(),
                violation_fn: Callable[[np.ndarray], np.ndarray] | None = None,
                initial_pop: np.ndarray | None = None):
    """Generator form of :func:`nsga2` — yields ``(gen, pop, objs)`` after
    each generation; the :class:`NSGA2Result` is the generator's *return*
    value (``StopIteration.value``).

    This is the substrate of the serving engine's off-critical-path
    re-optimization: ``core.runtime.ReoptJob`` advances one generation
    per decode step, interleaved with the in-flight decode dispatch.
    :func:`nsga2` drains this generator to completion, so the two entry
    points share one code path and are bit-identical for a given config.

    The work each ``next()`` runs, from resumption to the ``yield``, is
    one ``search.generation`` span, closed before the ``yield``: the
    first also scores the initial population, and the front's extraction
    after the last generation is one too.
    """
    rng = np.random.default_rng(config.seed)
    N = config.population

    def _eval(P):
        objs = np.asarray(eval_fn(P), dtype=np.float64)
        if objs.ndim != 2 or objs.shape[0] != P.shape[0]:
            raise ValueError(
                f"eval_fn must map the full [N, L] population to [N, M] in "
                f"one call; got {objs.shape} for N={P.shape[0]}")
        return objs

    def _initial():
        if initial_pop is not None:
            pop = np.asarray(initial_pop, dtype=np.int64)
            if pop.shape[0] < N:   # top up with random individuals
                extra = rng.integers(0, n_devices,
                                     size=(N - pop.shape[0], n_genes))
                pop = np.concatenate([pop, extra], axis=0)
            pop = pop[:N]
        else:
            pop = rng.integers(0, n_devices, size=(N, n_genes))
        objs = _eval(pop)
        viol = violation_fn(pop) if violation_fn is not None else None
        return pop, objs, viol

    def _generation(pop, objs, viol):
        ranks = fast_non_dominated_sort(objs, viol)
        crowd = crowding_distance(objs, ranks)
        pa = _tournament(rng, ranks, crowd, config.tournament_k, N)
        pb = _tournament(rng, ranks, crowd, config.tournament_k, N)
        children = _crossover(rng, pop[pa], pop[pb], config.crossover_rate)
        children = _mutate(rng, children, n_devices, config.mutation_rate)

        child_objs = _eval(children)
        child_viol = violation_fn(children) if violation_fn is not None \
            else None

        # (mu + lambda) elitist environmental selection
        allpop = np.concatenate([pop, children], axis=0)
        allobjs = np.concatenate([objs, child_objs], axis=0)
        allviol = (np.concatenate([viol, child_viol])
                   if viol is not None else None)
        aranks = fast_non_dominated_sort(allobjs, allviol)
        acrowd = crowding_distance(allobjs, aranks)
        order = np.lexsort((-acrowd, aranks))
        keep = order[:N]
        viol = allviol[keep] if allviol is not None else None
        return allpop[keep], allobjs[keep], viol

    pop = None
    history = []
    for g in range(config.generations):
        with span("search.generation"):
            if pop is None:
                pop, objs, viol = _initial()
            pop, objs, viol = _generation(pop, objs, viol)
            history.append(objs.min(axis=0))
        yield g, pop, objs

    with span("search.generation"):
        if pop is None:
            pop, objs, viol = _initial()
        ranks = fast_non_dominated_sort(objs, viol)
        front = ranks == 0
        # deduplicate identical chromosomes on the front
        fpop, fidx = np.unique(pop[front], axis=0, return_index=True)
        fobjs = objs[front][fidx]
    return NSGA2Result(pareto_pop=fpop, pareto_objs=fobjs, history=history,
                       evaluations=N * (config.generations + 1))


def nsga2(eval_fn: Callable[[np.ndarray], np.ndarray],
          n_genes: int, n_devices: int, config: NSGA2Config = NSGA2Config(),
          violation_fn: Callable[[np.ndarray], np.ndarray] | None = None,
          initial_pop: np.ndarray | None = None,
          callback: Callable[[int, np.ndarray, np.ndarray], None] | None = None,
          ) -> NSGA2Result:
    """Minimise the vector objective eval_fn over integer chromosomes.

    Args:
      eval_fn: [N, L] int chromosomes -> [N, M] objective matrix (minimise).
        **Contract:** eval_fn receives the whole population in ONE call
        per generation and must return the full [N, M] matrix from that
        call — nsga2 never loops over individuals, so a batched
        evaluator (e.g. ``ObjectiveFn`` backed by the row-batched
        ΔAcc engine) keeps device dispatch count O(generations), not
        O(generations × population).  Memory capping belongs inside
        eval_fn (``ObjectiveFn.eval_batch_size`` chunks the unique
        chromosomes per dispatch without changing results).
      n_genes: chromosome length L (number of layers).
      n_devices: alphabet size D (number of devices/tiers).
      violation_fn: optional [N, L] -> [N] constraint violation (<=0 feasible).
      initial_pop: optional seed population (e.g. the previous deployment
        for the online re-optimization phase).
      callback: called each generation with (gen, pop, objs).
    """
    gen = nsga2_steps(eval_fn, n_genes, n_devices, config=config,
                      violation_fn=violation_fn, initial_pop=initial_pop)
    while True:
        try:
            g, pop, objs = next(gen)
        except StopIteration as stop:
            return stop.value
        if callback is not None:
            callback(g, pop, objs)
