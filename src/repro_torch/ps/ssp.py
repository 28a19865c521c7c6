"""The SSP executor: bounded-staleness push/pull on the port's engine,
from the JAX package's ``ps/ssp.py``.

Stale-Synchronous Parallel (Xing et al. 2016; LightLDA, Yuan et al. 2014)
lets workers read shared parameters up to ``s`` clocks stale.  On the
STRADS primitives that becomes:

* **reads** of server-resident variables (the leaves whole on every
  worker, see :mod:`repro_torch.ps.server`) are served from a
  :class:`~repro_torch.ps.cache.StaleCache` instead of the freshly
  committed value;
* **pushes** aggregate lazily: each round's per-worker partials ``z`` go
  into a pending buffer, and only when the gate ``clock - cache.clock <=
  s`` would be violated does a **flush** run: one sum over the workers of
  every deferred partial (one ``.sum(0)`` per dtype), then the deferred
  commits (the app's own ``pull``) replayed in round order, then a cache
  refresh;
* **worker-resident** state stays exact: commit-through runs every round,
  so a worker sees its own writes at once (read-my-writes); only other
  workers' contributions arrive late.

Which writes commit through, which defer, and which priority entries are
masked for in-flight exclusion follows from the app's placement
(:class:`~repro_torch.core.kvstore.VarTable`).  With an injected
scheduler the priority table lives in the engine-owned carry: the window
masks it with ``scheduler.mark_scheduled`` between stale proposals,
folds it forward with ``app.sched_update`` per replayed commit, and
returns it as ``SSPCarry.sched_carry``.  The JAX package's deprecated v1
``ssp_*`` app hooks are not ported.

Rounds run in windows of ``s + 1``: the first round of a window reads a
fresh snapshot (staleness 0), the last one ``s`` commits old.  A window's
schedules are all made up front from the same snapshot and window-start
scheduler carry; only later *proposals* see the in-flight marks, while
the statistics and the schedule decisions read the unmarked view and
carry.  The window's ``schedule_stats`` are summed over the workers
together.  At ``staleness=0`` every window is one round and the
executor equals the ``scan`` executor to the bit.

The port runs eagerly on the current stream, in program order (the
kernels' cached workspaces are one set a card); a step is
``rounds_per_step`` = lcm(s + 1, ``phase_period``) rounds, the unit of
alignment for ``t0`` and for checkpoint chunks.  Round t's schedule
takes the t-th noise draw, as on every other executor, which is the JAX
SSP's order of key splits too.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Callable, List, Optional

import torch

from ..core.engine import _stack
from ..core.kvstore import VarTable
from ..core.primitives import tree_psum
from ..obs import counters as obs_counters
from . import telemetry as T
from .cache import StaleCache
from .server import ParameterServer, init_clocks, tick


@dataclasses.dataclass(frozen=True)
class SSPCarry:
    """Resumable carry of the SSP executor: the next round index, the
    per-worker vector clocks (int32 (W,)), the engine-owned scheduler
    carry (``None`` for stateless policies) and the noise generator's
    state (``None`` when the noise came from a caller's source, the JAX
    package's PRNG key's place), and under a telemetry spec the device
    counters (``obs``; ``None`` uninstrumented).  The SSP twin of
    :class:`repro_torch.core.EngineCarry`; it round-trips through
    :mod:`repro_torch.checkpoint` (``carry/.clocks`` and
    ``carry/.obs/...`` in the file)."""
    t: int
    clocks: torch.Tensor
    sched_carry: Any = None
    rng_state: Optional[torch.Tensor] = None
    obs: Any = None


def rounds_per_step(engine, staleness: int) -> int:
    """Rounds one step lays out: windows of ``s + 1`` must tile the app's
    static-phase cycle, so it is lcm(s + 1, phase_period)."""
    return math.lcm(staleness + 1, engine.phase_period)


# ---------------------------------------------------------------------------
# The sum over workers, batched
# ---------------------------------------------------------------------------

def _leaves(tree: Any) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree: Any, it) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def _batched_sum(trees: List[Any]) -> List[Any]:
    """Σ_workers of a list of trees in one ``.sum(0)`` per dtype: every
    leaf's (W, …) partial is flattened to (W, n), the leaves of a dtype
    concatenated, summed once and split back (a dtype with one leaf is
    summed alone).  ``None`` subtrees pass through (MF's W-phase pushes
    nothing)."""
    per_tree = [_leaves(t) for t in trees]
    leaves = [x for f in per_tree for x in f]
    summed: list = [None] * len(leaves)
    by_dtype: dict = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    for idxs in by_dtype.values():
        if len(idxs) == 1:
            summed[idxs[0]] = leaves[idxs[0]].sum(0)
            continue
        W = leaves[idxs[0]].shape[0]
        red = torch.cat([leaves[i].reshape(W, -1) for i in idxs],
                        dim=1).sum(0)
        off = 0
        for i in idxs:
            n = leaves[i][0].numel()
            summed[i] = red[off:off + n].view(leaves[i].shape[1:])
            off += n
    it = iter(summed)
    return [_rebuild(t, it) for t in trees]


def _tree_nbytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


# ---------------------------------------------------------------------------
# Round pieces
# ---------------------------------------------------------------------------

def _window_schedules(eng, table, view, sc, data, noises, ts, phases):
    """propose → [Σ_workers of the window's stats, batched] → schedule for
    a whole window, all from the same stale view and window-start
    scheduler carry.  Between proposals the view and carry pass through
    the in-flight exclusion, so later proposals avoid variables already
    in flight; the statistics and decisions read the unmarked ones."""
    app = eng.app
    cands = []
    marked, marked_sc = view, sc
    for i, (g, t, ph) in enumerate(zip(noises, ts, phases)):
        c = app.propose(marked, marked_sc, g, t, ph)
        cands.append(c)
        if i + 1 < len(ts):          # only later proposals see the mark
            marked = table.mark_scheduled(marked, c)
            marked_sc = eng.mark_sched_carry(marked_sc, c)
    if eng._needs_stats:
        stats = _batched_sum([app.schedule_stats(data, view, c, ph)
                              for c, ph in zip(cands, phases)])
    else:
        stats = [None] * len(ts)
    return [app.schedule(view, sc, c, s, t, ph)
            for c, s, t, ph in zip(cands, stats, ts, phases)]


def _commit(app, table, state, sched, z, keep, data, phase):
    """The shared commit: the app's own ``pull`` with its ``local``
    rebuilt (commit-through leaves from the live state, the rest from
    the deferred buffer)."""
    local = table.rebuild_local(state, keep, phase)
    return app.pull(state, sched, z, local, data, phase)


def _fused_round(app, table, view, data, sched, phase, info: dict, sc,
                 tm):
    """``staleness=0``: the window is one round, so nothing is deferred —
    push → commit-through → Σ_workers → shared commit → ``sched_update``,
    the BSP round, under the ``push`` and ``pull`` timers.  Returns the
    new state and scheduler carry."""
    with tm("push"):
        z, local = app.push(data, view, sched, phase)
        st = table.commit_local(view, local, phase)
        keep = table.defer_local(local, phase)
        _account(info, _tree_nbytes(z))
        z = tree_psum(z)
    with tm("pull"):
        new_state = _commit(app, table, st, sched, z, keep, data, phase)
        return new_state, app.sched_update(sc, view, new_state, sched,
                                           phase)


def _account(info: dict, window_bytes: int) -> None:
    info["deferred_bytes_peak"] = max(info.get("deferred_bytes_peak", 0),
                                      window_bytes)
    info["bytes_pushed"] = info.get("bytes_pushed", 0) + window_bytes


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------

def _check_rounds(eng, num_rounds: int, staleness: int) -> int:
    if staleness < 0:
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    L = rounds_per_step(eng, staleness)
    num_steps, tail = divmod(num_rounds, L)
    if tail or num_steps == 0:
        raise ValueError(
            f"run_ssp needs num_rounds to be a positive multiple of "
            f"lcm(staleness+1, phase_period) = {L}; got {num_rounds}")
    return num_steps


_UNSET = object()


def run_ssp(eng, state, data, generator, num_rounds: int, *,
            staleness: int = 0, collect: Optional[Callable] = None,
            with_telemetry: bool = False, t0: int = 0,
            clocks: Optional[torch.Tensor] = None,
            sched_carry0: Any = _UNSET, obs0: Any = None,
            return_carry: bool = False,
            noise: Optional[Callable[[int], Any]] = None):
    """Execute ``num_rounds`` rounds under bounded staleness ``s``.

    ``staleness=0`` equals the ``scan`` executor to the bit (the same
    noise draws, the same op order).  At ``s >= 1`` reads of
    server-resident state are up to ``s`` rounds stale and pushes are
    summed over the workers once a window.

    ``generator`` (``None``: a fresh one seeded 0) draws the schedules'
    noise, or ``noise(t)`` replaces it.  ``collect(state)`` runs after
    every committed round, inside the flush; the stacked trace has
    ``num_rounds`` rows.  ``t0``, ``clocks`` and ``sched_carry0`` resume
    a previous run (the values of its :class:`SSPCarry`; ``t0`` a
    multiple of the step length; without ``sched_carry0`` a fresh
    scheduler carry is used, which is right only at ``t0=0``).  ``obs0``
    threads the engine's device counters
    (:func:`repro_torch.obs.counters.init_counters`, or a previous
    carry's ``obs``) through the rounds, folded once a round from the
    schedule it ran; ``None`` runs uninstrumented.
    ``with_telemetry=True`` appends an
    :class:`~repro_torch.ps.telemetry.SSPTelemetry` (the staleness
    histogram of the reads served and the push/pull bytes), and
    ``return_carry=True`` the final :class:`SSPCarry`.  Through
    ``StradsEngine.execute`` the summary lands in the ``ssp`` section of
    the run's :class:`~repro_torch.obs.RunReport`, merged over chunks."""
    num_steps = _check_rounds(eng, num_rounds, staleness)
    L = rounds_per_step(eng, staleness)
    if t0 % L:
        raise ValueError(f"t0 must be a multiple of the step length {L} "
                         f"(phase/window alignment); got {t0}")
    if clocks is None:
        clocks = init_clocks(eng.workers, eng.device)
    if sched_carry0 is _UNSET:
        sched_carry0 = eng.init_sched_carry()
        if t0 and sched_carry0 is not None:
            warnings.warn(
                "run_ssp(t0>0) without sched_carry0 reinitializes the "
                "stateful scheduler's priorities; pass the "
                "SSPCarry.sched_carry a previous run returned for a "
                "bit-exact resume", UserWarning, stacklevel=2)
    generator = eng._generator(generator)
    # the server/cache split follows the engine's store when place_state
    # built one, else the app's declarations over this state
    if eng.kvstore is not None:
        server = ParameterServer(eng.kvstore)
    else:
        server = ParameterServer.from_state(
            eng.workers, state, {k: eng.state_specs.get(k) for k in state},
            roles=eng.app_roles())
    # commit-through, deferral and in-flight exclusion follow from the
    # store's VarSpecs
    table = VarTable(server.store)
    app = eng.app
    W = staleness + 1
    sc = sched_carry0
    obs = obs0
    num_cand = eng._obs_num_candidates()
    period = eng.phase_period
    telem = T.staleness_init(staleness)
    info = {"shared_bytes": server.shared_nbytes()}
    ys: list = []
    t = t0
    # a window's timers count its s + 1 rounds: its schedules are made
    # together, and its pushes and commits timed as one interval each
    tm = eng._timer()
    for _ in range(num_steps):
        cache = StaleCache(values=server.snapshot(state), clock=t)
        for w0 in range(0, L, W):
            with tm("round", W):
                ts = [t + w0 + k for k in range(W)]
                phases = [app.static_phase(tk) for tk in ts]
                with tm("schedule", W):
                    noises = [eng._noise(generator, noise, tk) for tk in ts]
                    # the gate, laid out: the window's last read is
                    # exactly at the bound, so the flush below comes
                    # before the next round
                    assert cache.fresh_enough(ts[-1], staleness)
                    scheds = _window_schedules(
                        eng, table, server.merge(state, cache.values), sc,
                        data, noises, ts, phases)
                if W == 1:
                    view = server.merge(state, cache.values)
                    state, sc = _fused_round(app, table, view, data,
                                             scheds[0], phases[0], info, sc,
                                             tm)
                    T.observe_read(telem, ts[0], cache.clock)
                    if obs is not None:
                        obs = obs_counters.observe_round(
                            obs, scheds[0], ts[0] % period, num_cand)
                    clocks = tick(clocks)
                    if collect is not None:
                        ys.append(collect(state))
                    cache = cache.refresh(server.snapshot(state), ts[-1] + 1)
                    continue

                # no view outlives its push: a view holds the window-start
                # tensors of the worker-resident leaves the commits replace
                # (MF's R is 9.3 GB at the chip shape)
                with tm("push", W):
                    z_pends, keep_pends = [], []
                    for k in range(W):
                        z, local = app.push(
                            data, server.merge(state, cache.values),
                            scheds[k], phases[k])
                        state = table.commit_local(state, local, phases[k])
                        keep_pends.append(table.defer_local(local,
                                                            phases[k]))
                        z_pends.append(z)
                        T.observe_read(telem, ts[k], cache.clock)
                        if obs is not None:
                            obs = obs_counters.observe_round(
                                obs, scheds[k], ts[k] % period, num_cand)
                        clocks = tick(clocks)
                    # the bound forces a sync: flush the pending buffer
                    # (one sum over workers)
                    _account(info, sum(_tree_nbytes(z) for z in z_pends))
                    zs = _batched_sum(z_pends)
                # replay the deferred commits in round order with the
                # scheduler carry folded per commit, then refresh
                with tm("pull", W):
                    for k in range(W):
                        new_state = _commit(app, table, state, scheds[k],
                                            zs[k], keep_pends[k], data,
                                            phases[k])
                        sc = app.sched_update(sc, state, new_state,
                                              scheds[k], phases[k])
                        state = new_state
                        if collect is not None:
                            ys.append(collect(state))
                cache = cache.refresh(server.snapshot(state), ts[-1] + 1)
        t += L

    carry = SSPCarry(t=t, clocks=clocks, sched_carry=sc,
                     rng_state=(None if noise is not None
                                else generator.get_state()), obs=obs)
    ret = [state]
    if collect is not None:
        ret.append(_stack(ys))
    if with_telemetry:
        ret.append(T.summarize(telem, info, staleness=staleness,
                               rounds=num_rounds,
                               flushes=num_steps * (L // W),
                               clocks=clocks))
    if return_carry:
        ret.append(carry)
    return ret[0] if len(ret) == 1 else tuple(ret)


__all__ = ["SSPCarry", "rounds_per_step", "run_ssp"]
