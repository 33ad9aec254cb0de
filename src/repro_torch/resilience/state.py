"""Full-session save/restore: the atomic manifest behind ``Session.save`` —
the port of ``repro.resilience.state``.

``Session`` owns more state than its weights: stage records, squeeze
history, the trainability mask, the conversion report, and the weights
version that guards serving snapshots against staleness.  Losing any of it
across a preemption forfeits either the lifecycle report (the paper's
deliverable) or the staleness protection, so the whole session persists
together:

    <dir>/weights/step_<v>/...   params via CheckpointManager (atomic
                                 step dirs, ``latest`` symlink, keep-2)
    <dir>/session.json           the manifest: config, stage, records,
                                 squeeze history, mask, weights version
    <dir>/autotune.json          the autotuner's verdicts (``export_cache``)

The layout, the manifest (format 1) and its keys are the reference's, so a
session saved by either package restores in the other.  Write order is
weights -> manifest, and the manifest itself is written atomically (tmp +
rename), so a crash at any point leaves the directory either at the
previous complete session or the new one — the manifest names the weights
step it belongs to, and the weights manager keeps the prior step until the
new manifest is durable.

``save`` exports the autotuner's verdicts beside the manifest
(``"autotune_entries"`` counts them) and ``restore`` merges that file into
the local verdict cache, local verdicts first, so a restored session plans
without tuning again on the card that measured them.  Each package writes
its own cache format (``kernels/autotune.CACHE_VERSION``) and its keys
name their substrate, so a directory saved by the other package restores
with nothing imported from its ``autotune.json``.

Restore builds the model from the serialized config on the requested
device and installs the saved tree with ``Model.set_tree`` (squeezed bonds
included), so a restored session serves token-identically to the one that
was saved.
"""

from __future__ import annotations

import dataclasses
import json
import os

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.lightweight import leaves
from repro_torch.kernels import autotune
from repro_torch.resilience.journal import event_from_json, event_to_json

MANIFEST = "session.json"
TUNE_FILE = "autotune.json"
FORMAT = 1


def atomic_write_json(path: str, obj) -> None:
    """tmp + rename so a reader never sees a torn manifest.  ``obj`` holds
    Python values only: a tensor or numpy scalar raises ``TypeError``."""
    text = json.dumps(obj, indent=2, sort_keys=True) + "\n"   # raises before any write
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _cfg_from_json(d: dict):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.layers import MPOConfig
    d = dict(d)
    d["mpo"] = MPOConfig(**d["mpo"])
    return ModelConfig(**d)


def _unflatten_like(tree, flat: list):
    """``tree``'s nested-dict structure holding ``flat``'s values, in
    ``lightweight.leaves`` order (keys sorted, JAX's leaf order)."""
    n = sum(1 for _ in leaves(tree))
    if len(flat) != n:
        raise ValueError(f"the manifest's mask has {len(flat)} leaves, the params {n}")
    it = iter(flat)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)

    return walk(tree)


def save_session(session, directory: str) -> str:
    """Persist ``session`` under ``directory`` (see module docstring for
    layout and crash-consistency).  Returns the directory."""
    os.makedirs(directory, exist_ok=True)
    step = session.weights_version
    mgr = CheckpointManager(os.path.join(directory, "weights"), keep=2,
                            async_save=False)
    mgr.save(step, session.params, extra_meta={"weights_version": step}, block=True)
    tune = autotune.export_cache(os.path.join(directory, TUNE_FILE))
    manifest = {
        "format": FORMAT,
        "cfg": dataclasses.asdict(session.cfg),
        "stage": session.stage,
        "weights_version": step,
        "weights_step": step,
        "stages": [dataclasses.asdict(r) for r in session._records],
        "squeeze_history": [event_to_json(e) for e in session.squeeze_history],
        "conversion_report": dict(session.conversion_report),
        # the mask mirrors the params' keys, so its flat leaf order is a
        # faithful (and JSON-native) encoding
        "mask": (None if session.mask is None
                 else [bool(x) for x in leaves(session.mask)]),
        "autotune_entries": tune["exported"],
    }
    atomic_write_json(os.path.join(directory, MANIFEST), manifest)
    return directory


def restore_session(directory: str, cls=None, device=None):
    """Rebuild a ``Session`` from ``save_session`` output (the port's or the
    reference's) on ``device`` (the card when None; raises without one).
    ``cls`` defaults to ``repro_torch.pipeline.session.Session``."""
    path = os.path.join(directory, MANIFEST)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"no session manifest at {path}; was this directory written by "
            "Session.save?") from None
    if manifest.get("format") != FORMAT:
        raise ValueError(
            f"unsupported session manifest format "
            f"{manifest.get('format')!r} (this build reads {FORMAT})")
    from repro_torch.models import model as M
    from repro_torch.pipeline.session import StageRecord
    if cls is None:
        from repro_torch.pipeline.session import Session as cls
    cfg = _cfg_from_json(manifest["cfg"])
    model = M.build(cfg, device=device)
    mgr = CheckpointManager(os.path.join(directory, "weights"), async_save=False)
    params, _ = mgr.restore(manifest["weights_step"], model.tree())
    model.set_tree(params)
    session = cls(cfg, model, model.axes)
    session.stage = manifest["stage"]
    session._version = int(manifest["weights_version"])
    session._records = [StageRecord(**r) for r in manifest["stages"]]
    session.squeeze_history = [event_from_json(e) for e in manifest["squeeze_history"]]
    session.conversion_report = dict(manifest["conversion_report"])
    if manifest["mask"] is not None:
        session.mask = _unflatten_like(session.params, manifest["mask"])
    tune_path = os.path.join(directory, TUNE_FILE)
    if os.path.exists(tune_path):
        autotune.import_cache(tune_path)
    return session
