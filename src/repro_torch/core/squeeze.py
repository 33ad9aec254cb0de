"""Dimension squeezing (paper Algorithm 2) — the port of
``repro.core.squeeze``.

Repeatedly: (1) among all MPO-factorized matrices in the model, find the bond
whose next truncation predicts the least added reconstruction error (from
the bond spectra, Eq. 3); (2) truncate that bond by ``step`` (TT-rounding);
(3) lightweight-fine-tune the auxiliary tensors; (4) stop when the metric gap
exceeds ``delta`` or ``max_iters`` is reached.  Stacked ``(L, ...)`` cores are
handled as one batch a bond, on their device; a MoE layer's ``(L, E, ...)``
experts are refused, as the reference refuses them.  ``faults.step_tick`` at the
top of every iteration is the chaos harness's preemption hook; a preempted
run resumes from its journal (``resilience.journal.SqueezeJournal``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.core import mpo
from repro_torch.core.layers import cores_from_list, cores_to_list
from repro_torch.core.lightweight import leaves
from repro_torch.resilience import faults

# ---- locating MPO layers inside a nested-dict param tree ----


def find_mpo_layers(params, prefix=()) -> dict:
    """{path_tuple: cores_dict} for every MPO-factorized matrix."""
    out = {}
    if isinstance(params, dict):
        if "central" in params:  # a cores-dict itself
            out[prefix] = params
            return out
        for k, v in params.items():
            out.update(find_mpo_layers(v, prefix + (k,)))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out.update(find_mpo_layers(v, prefix + (i,)))
    return out


def set_at_path(params, path, value):
    """Functionally replace the subtree at ``path`` (dicts/lists only): the
    containers along ``path`` are copied, every other leaf is shared."""
    if not path:
        return value
    k, rest = path[0], path[1:]
    if isinstance(params, dict):
        new = dict(params)
        new[k] = set_at_path(params[k], rest, value)
        return new
    new = list(params)
    new[k] = set_at_path(params[k], rest, value)
    return type(params)(new) if isinstance(params, tuple) else new


# ---- Algorithm 2 ----


@dataclasses.dataclass
class SqueezeEvent:
    step: int
    layer: tuple
    bond: int
    new_dim: int
    predicted_error: float
    metric: float
    # wall seconds of the iteration's parts: spectra, tt_round, retune, eval;
    # not compared: two runs of the same iteration are equal events
    seconds: dict = dataclasses.field(default_factory=dict, compare=False)


def _eps_for(spectra_k: torch.Tensor, keep: int) -> torch.Tensor:
    """Eq. 3 local error (a 0-dim tensor on the spectra's device); stacked
    layers combine as sqrt(sum_l eps_l^2)."""
    per = mpo.local_truncation_error(spectra_k, keep)
    return per if per.dim() == 0 else torch.sqrt((per * per).sum())


# Algorithm 2 over cores of more than one stacked dim is refused, as the
# reference refuses it
EXPERT_STACKS = ("Algorithm 2 over a MoE layer's (L, E) expert stacks is not ported: the "
                 "reference's squeeze takes at most one stacked dim (5-D cores, "
                 "repro/core/squeeze.py:69-77) and fails on 6-D ones (ROADMAP.md, Queue 3 I)")


def candidates(layers: dict, *, step: int = 1, min_bond: int = 1) -> list[tuple]:
    """Every squeeze move, in the reference's order of visit:
    ``[(path, bond_index, new_bonds, predicted_eps), ...]``.  A stack's
    spectra come from one batched sweep (``(L, svals)`` a bond); the errors
    are read back to the host in one transfer.  Cores of more than one
    stacked dim (a MoE layer's experts) raise ``NotImplementedError``."""
    found, eps = [], []
    for path, cores_dict in layers.items():
        cores = cores_to_list(cores_dict)
        if cores[0].dim() > 5:
            raise NotImplementedError(EXPERT_STACKS)
        bonds = [c.shape[-1] for c in cores[:-1]]
        for k, s in enumerate(mpo.bond_spectra(cores)):
            new = min(bonds[k], s.shape[-1]) - step
            if new < min_bond:
                continue
            nb = list(bonds)
            nb[k] = new
            found.append((path, k, nb))
            eps.append(_eps_for(s, new).float())
    if not found:
        return []
    values = torch.stack(eps).tolist()
    return [(*f, e) for f, e in zip(found, values)]


def least_error_candidate(layers: dict, *, step: int = 1, min_bond: int = 1):
    """(path, bond_index, new_bonds, predicted_eps) minimizing Eq. 3 error;
    the first of equal errors, as the reference picks."""
    best = None
    for cand in candidates(layers, step=step, min_bond=min_bond):
        if best is None or cand[-1] < best[-1]:
            best = cand
    return best


def _clock(params) -> float:
    """``time.perf_counter()`` once the tree's device has finished its work."""
    for t in leaves(params):
        if isinstance(t, torch.Tensor):
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            break
    return time.perf_counter()


def squeeze_once(params, *, step: int = 1, min_bond: int = 1):
    """One squeeze move; returns (new_params, event_info) or (params, None).
    The new tree shares every leaf but the squeezed matrix's cores."""
    t0 = _clock(params)
    layers = find_mpo_layers(params)
    cand = least_error_candidate(layers, step=step, min_bond=min_bond)
    if cand is None:
        return params, None
    t1 = _clock(params)
    path, k, new_bonds, eps = cand
    cores = cores_to_list(layers[path])
    # stacked: the same bond truncated across the whole stack (uniform bonds
    # keep the stack homogeneous)
    new_cores, _ = mpo.tt_round(cores, new_bonds)
    # contiguous, as a tree read back from a journal is: a resumed run then
    # feeds every op the layout the uninterrupted run fed it
    new_cores = [c.to(cores[i].dtype).contiguous() for i, c in enumerate(new_cores)]
    params = set_at_path(params, path, cores_from_list(new_cores))
    t2 = _clock(params)
    return params, dict(layer=path, bond=k, new_dim=new_bonds[k], predicted_error=eps,
                        seconds={"spectra": t1 - t0, "tt_round": t2 - t1})


def run_dimension_squeezing(
    params,
    finetune_fn: Callable,   # params -> params (LFA on aux tensors)
    eval_fn: Callable,       # params -> scalar metric (higher = better)
    *,
    delta: float,
    max_iters: int,
    step: int = 1,
    min_bond: int = 1,
    verbose: bool = False,
    weight_cache: Callable | None = None,
    start_iter: int = 0,
    initial_history: list | None = None,
    baseline_metric: float | None = None,
    on_iteration: Callable | None = None,
):
    """Paper Algorithm 2.  Returns (params, history).

    ``weight_cache`` (``MPOEngine.cache_weights``) makes every evaluation run
    on a freshly densified serving snapshot, rebuilt from the current cores
    after each truncation + fine-tune, so a cached W contracted before the
    bond was squeezed is never consulted.  When the gap ``|p0 - metric|``
    exceeds ``delta`` the last acceptable tree is returned: the rejected
    tree is a new one (``squeeze_once`` copies the path it changes, and
    ``finetune_fn`` must not write into the tree it is given), so the
    accepted one is never touched.

    Resumability (``resilience.journal.SqueezeJournal`` /
    ``Session.squeeze(ckpt_dir=...)``): ``on_iteration(it, params, history,
    baseline)`` fires after every ACCEPTED iteration; a preempted run passes
    the journaled ``start_iter`` / ``initial_history`` / ``baseline_metric``
    (and the journaled params) back in and continues at the last completed
    iteration.  A given baseline skips the p0 evaluation: re-evaluating it
    on already-squeezed params would corrupt the stop rule."""
    ev = eval_fn if weight_cache is None else (lambda p: eval_fn(weight_cache(p)))
    history: list[SqueezeEvent] = list(initial_history or [])
    p0 = float(baseline_metric) if baseline_metric is not None else float(ev(params))
    best_params = params
    for it in range(start_iter, max_iters):
        faults.step_tick("squeeze", it)
        new_params, info = squeeze_once(params, step=step, min_bond=min_bond)
        if info is None:
            break
        t0 = _clock(new_params)
        new_params = finetune_fn(new_params)
        t1 = _clock(new_params)
        metric = float(ev(new_params))
        t2 = _clock(new_params)
        history.append(SqueezeEvent(it, info["layer"], info["bond"], info["new_dim"],
                                    info["predicted_error"], metric,
                                    dict(info["seconds"], retune=t1 - t0, eval=t2 - t1)))
        if verbose:
            print(f"[squeeze {it}] layer={info['layer']} bond={info['bond']}"
                  f"->{info['new_dim']} eps={info['predicted_error']:.4g}"
                  f" metric={metric:.4f} (ref {p0:.4f})")
        if abs(p0 - metric) > delta:
            # gap exceeded: keep the last acceptable model (Alg. 2 stop)
            return best_params, history
        params = new_params
        best_params = new_params
        if on_iteration is not None:
            on_iteration(it, params, history, p0)
    return best_params, history


def model_compression_ratio(params) -> float:
    """Aggregate Eq. 5 rho: core parameters over the dense parameters of the
    same matrices, each layer of a stack counted as its own matrix.  (The
    reference reads a stacked core's ``shape[1]`` / ``shape[2]`` as its i/j
    legs, which are its ``d0`` and ``i``: ROADMAP.md, Queue 3 item C.)"""
    num = den = 0
    for cores_dict in find_mpo_layers(params).values():
        cores = cores_to_list(cores_dict)
        stack = cores[0].shape[:-4].numel()
        num += sum(c.numel() for c in cores)
        den += stack * (torch.Size(c.shape[-3] for c in cores).numel()
                        * torch.Size(c.shape[-2] for c in cores).numel())
    return num / max(den, 1)
