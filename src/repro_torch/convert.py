"""Carry state from the JAX package into the port.

Carriers: :func:`lasso_from_jax`, :func:`mf_from_jax` and
:func:`lda_from_jax` for the STRADS apps' runs,
:func:`checkpoint_from_jax` for a checkpoint the JAX package's engine
wrote (:func:`stream_state_from_jax` for a streamed one's cursor),
:func:`model_params_from_jax` for the model zoo's parameters and
:func:`train_state_from_jax` for its train states.

The JAX package keeps β replicated, r and the data row-sharded over a
``data`` mesh axis, and the dynamic-priority scheduler's Δβ history in
its ``EngineCarry.sched_carry``.  :func:`lasso_from_jax` takes those as
numpy arrays (``np.asarray`` of the JAX values) and returns the port's
state, data and :class:`~repro_torch.core.EngineCarry` on ``device``, in
the port's worker layout.  A run that resumes from them with the same
scheduler noise continues on the JAX run's trajectory.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .checkpoint.npz import leaf_tensor
from .core import EngineCarry, resolve_device
from .models import params as P
from .ps import SSPCarry
from .models.transformer import stack_template


def _rows(x: np.ndarray, workers: int, device) -> torch.Tensor:
    x = torch.tensor(np.asarray(x, np.float32), device=device)
    if x.shape[0] % workers:
        raise ValueError(f"{x.shape[0]} rows do not split evenly over "
                         f"{workers} workers")
    return x.reshape(workers, x.shape[0] // workers, *x.shape[1:])


def lasso_from_jax(state: dict, X: np.ndarray, y: np.ndarray, *,
                   sched_carry: Optional[np.ndarray] = None, t: int = 0,
                   workers: int = 1, device="cuda"):
    """``state`` is ``{"beta": (J,), "r": (n,)}``, ``sched_carry`` the
    (J,) priority history (``None`` for stateless schedulers) and ``t``
    the next round index.  Returns ``(state, data, carry)`` for
    :meth:`~repro_torch.core.StradsEngine.execute`: β (J,), r (W, n/W),
    X (W, n/W, J), y (W, n/W)."""
    device = resolve_device(device)
    out_state = {
        "beta": torch.tensor(np.asarray(state["beta"], np.float32),
                             device=device),
        "r": _rows(state["r"], workers, device),
    }
    data = {"X": _rows(X, workers, device), "y": _rows(y, workers, device)}
    sc = (None if sched_carry is None else
          torch.tensor(np.asarray(sched_carry, np.float32), device=device))
    return out_state, data, EngineCarry(t=int(t), sched_carry=sc)


def mf_from_jax(state: dict, A: np.ndarray, mask: np.ndarray, *,
                t: int = 0, workers: int = 1, device="cuda"):
    """``state`` is the JAX MF state ``{"W": (N, K), "H": (K, M), "R":
    (N, M)}`` and ``t`` the next round index.  Returns ``(state, data,
    carry)``: W (P, N/P, K), H (K, M), R (P, N/P, M), A and the mask
    (P, N/P, M), for P = ``workers``."""
    device = resolve_device(device)
    out_state = {
        "W": _rows(state["W"], workers, device),
        "H": torch.tensor(np.asarray(state["H"], np.float32), device=device),
        "R": _rows(state["R"], workers, device),
    }
    data = {"A": _rows(A, workers, device),
            "mask": _rows(mask, workers, device)}
    return out_state, data, EngineCarry(t=int(t))


def lda_from_jax(state: dict, words: np.ndarray, docs: np.ndarray, *,
                 t: int = 0, workers: int = 1, device="cuda"):
    """``state`` is the JAX STRADS LDA state ``{"z": (U·T_p,), "D":
    (U·dpw, K), "B": (V_p, K), "s": (K,), "s_err": ()}`` and ``t`` the
    next round index.  Returns ``(state, data, carry)`` in the worker
    layout: z, words, docs (U, T_p) int32, D (U, dpw, K), and B
    (U, V_b, K) by home block, for U = ``workers``."""
    device = resolve_device(device)

    def ints(x):
        x = torch.tensor(np.asarray(x, np.int32), device=device)
        return x.reshape(workers, -1)

    out_state = {"z": ints(state["z"]),
                 "D": _rows(state["D"], workers, device),
                 "B": _rows(state["B"], workers, device),
                 **{k: torch.tensor(np.asarray(state[k], np.float32),
                                    device=device) for k in ("s", "s_err")}}
    data = {"words": ints(words), "docs": ints(docs)}
    return out_state, data, EngineCarry(t=int(t))


def checkpoint_from_jax(flat: dict, engine):
    """A checkpoint of the JAX package's ``StradsEngine.execute`` (the
    flat arrays its ``checkpoint.load_flat`` returns) as a resume point
    of the port's ``engine``.  Returns ``(state, carry, partition)`` for
    ``engine.execute(state, data, None, plan, carry=carry,
    partition=partition, noise=...)``:

    - ``state``: every ``state/<leaf>`` placed by ``engine.place_state``
      (row-split over the engine's workers where the app's state spec
      is ``"data"``, as :func:`lasso_from_jax` lays it out);
    - ``carry``: an :class:`~repro_torch.core.EngineCarry` with the round
      index, the scheduler carry and, when the JAX run was pipelined, its
      in-flight schedule (``depth`` 1; integer leaves as int64 indices,
      as the port's schedulers make them); or, when the file holds
      ``carry/.clocks`` (an SSP run), an
      :class:`~repro_torch.ps.SSPCarry` with the round index, the vector
      clocks (lockstep: the JAX run's clock for each of the engine's
      workers) and the scheduler carry; either carry with the device
      telemetry counters (``obs``, int32 on the engine's device) when
      the JAX run was instrumented (``carry/.obs/...``);
    - ``partition``: the ``"assignment"`` payload, or ``None``.

    The JAX PRNG key (``carry/.rng``) cannot cross: the carry has no
    generator state, so the caller passes ``noise=`` with the JAX
    package's draws to continue its trajectory.  A JAX pipelined run
    whose schedule is implicit (LDA's rotation) saves no in-flight
    schedule, so its checkpoint resumes here only on ``scan``/``loop``."""
    dev = engine.device

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in flat.items()
                if k.startswith(prefix)}

    state = engine.place_state(sub("state/"))
    sched = {k: torch.as_tensor(np.asarray(v).astype(
        np.int64 if np.issubdtype(np.asarray(v).dtype, np.integer)
        else np.asarray(v).dtype), device=dev)
        for k, v in sub("carry/.sched/").items()}
    sc = flat.get("carry/.sched_carry")
    sc = (None if sc is None else torch.as_tensor(
        np.asarray(sc, np.float32), device=dev))
    obs = {k: torch.as_tensor(np.asarray(v, np.int32), device=dev)
           for k, v in sub("carry/.obs/").items()} or None
    if "carry/.clocks" in flat:
        # the workers' clocks advance in lockstep: the JAX run's value,
        # over this engine's workers
        clock = int(np.min(flat["carry/.clocks"]))
        carry = SSPCarry(t=int(flat["carry/.t"]), sched_carry=sc,
                         clocks=torch.full((engine.workers,), clock,
                                           dtype=torch.int32, device=dev),
                         obs=obs)
    else:
        carry = EngineCarry(t=int(flat["carry/.t"]), sched_carry=sc,
                            sched=sched or None, depth=1 if sched else 0,
                            obs=obs)
    return state, carry, sub("assignment/") or None


def stream_state_from_jax(flat: dict) -> Optional[dict]:
    """The ``"stream"`` payload of a streamed JAX checkpoint (its
    ``stream/cursor``, ``stream/rows_in``, ``stream/rows_dropped`` and
    ``stream/fill0``) as the ``stream_state=`` the port's ``execute`` and
    :func:`repro_torch.stream.replay_data` resume from: the same
    numpy int64 cursor.  ``None`` when the run did not stream."""
    from .stream.ingest import _CURSOR_KEYS
    if not any(k.startswith("stream/") for k in flat):
        return None
    missing = [k for k in _CURSOR_KEYS if f"stream/{k}" not in flat]
    if missing:
        raise ValueError(f"checkpoint stream payload missing {missing}")
    return {k: np.int64(np.asarray(flat[f"stream/{k}"]))
            for k in _CURSOR_KEYS}


def _tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    return leaf_tensor(x).to(device=device, dtype=dtype)


def model_params_from_jax(params_numpy: dict, cfg, device="cuda") -> dict:
    """The JAX package's model parameters (``init_params``' tree with
    numpy leaves, e.g. ``jax.tree.map(np.asarray, prm)``) as the port's:
    the same nested dict, each leaf a tensor in the config's dtype on
    ``device`` (the SSM's ``A_log`` and ``dt_bias`` in float32, as the
    JAX package keeps them).  The two packages lay every leaf out alike
    (stacked layers, padded heads and vocabulary), so this checks each
    key and shape against :func:`stack_template` and copies."""
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)

    def check_keys(path, tmpl, tree):
        if isinstance(tmpl, dict):
            if not isinstance(tree, dict) or set(tree) != set(tmpl):
                got = sorted(tree) if isinstance(tree, dict) else type(tree)
                raise ValueError(f"params{list(path)}: keys {got} are not "
                                 f"the template's {sorted(tmpl)}")
            for k in tmpl:
                check_keys(path + (k,), tmpl[k], tree[k])

    def leaf(path, meta, x):
        if tuple(np.shape(x)) != meta.shape:
            raise ValueError(f"params{list(path)}: shape {np.shape(x)} is "
                             f"not the template's {meta.shape}")
        return _tensor(x, torch.float32 if meta.init in P.SSM_INITS
                       else dtype, device)

    tmpl = stack_template(cfg)
    check_keys((), tmpl, params_numpy)
    return P.tree_map(leaf, tmpl, params_numpy)


def train_state_from_jax(state_numpy: dict, cfg, device="cuda",
                         generator: Optional[torch.Generator] = None
                         ) -> dict:
    """A train state of the JAX package (``init_train_state`` /
    ``init_strads_state``, or a restored checkpoint, with numpy leaves) as
    the port's: the parameters through :func:`model_params_from_jax`,
    the AdamW moments in their own dtype (bfloat16 bit for bit), ``count``
    and ``step`` (int32), and for STRADS ``priority`` and ``mask``.

    The JAX PRNG key (``rng``) cannot cross: a STRADS state takes
    ``generator``'s state as its ``rng`` (required when the JAX state has
    one), or the caller passes the JAX Gumbel draws to each step.  A flat
    dict of '/'-joined paths (a checkpoint's :func:`~repro_torch.
    checkpoint.load_flat`) is taken too."""
    device = resolve_device(device)
    if any("/" in k for k in state_numpy):
        nested: dict = {}
        for k, x in state_numpy.items():
            *head, last = k.split("/")
            node = nested
            for h in head:
                node = node.setdefault(h, {})
            node[last] = x
        state_numpy = nested
    out = {"params": model_params_from_jax(state_numpy["params"], cfg,
                                           device)}
    tmpl = stack_template(cfg)

    def moment(path, meta, x):
        if tuple(np.shape(x)) != meta.shape:
            raise ValueError(f"opt{list(path)}: shape {np.shape(x)} is not "
                             f"the template's {meta.shape}")
        t = leaf_tensor(x)
        return t.to(device=device, dtype=t.dtype)

    opt = state_numpy["opt"]
    out["opt"] = {"m": P.tree_map(moment, tmpl, opt["m"]),
                  "v": P.tree_map(moment, tmpl, opt["v"]),
                  "count": torch.tensor(np.asarray(opt["count"]),
                                        dtype=torch.int32, device=device)}
    out["step"] = torch.tensor(np.asarray(state_numpy["step"]),
                               dtype=torch.int32, device=device)
    for k in ("priority", "mask"):
        if k in state_numpy:
            out[k] = torch.tensor(np.asarray(state_numpy[k], np.float32),
                                  device=device)
    if "rng" in state_numpy or "priority" in state_numpy:
        if generator is None:
            raise ValueError("a STRADS state's JAX PRNG key cannot cross: "
                             "pass generator= for the port's rng")
        out["rng"] = generator.get_state()
    return out
