"""The port's logical axes and sharding rules (``repro_torch.core.layers``'
``Annot`` / ``axes_for``, ``repro_torch.parallel.sharding``) against the
JAX package's — pure Python, no process group: meshes are stand-ins with
``mesh_dim_names`` and ``shape`` (the reference's
``analysis.sharding_lint.MeshSpec`` on its side).

- The axes tree equals the reference's ``init_params`` axes key path by
  key path for every arch's smoke config, and at full width (the port's
  built on the ``meta`` device, the reference's by ``jax.eval_shape``),
  where the leaf shapes agree too.
- ``make_rules`` / ``head_safe_rules`` / ``resolve_dims`` / ``spec_for``
  equal the reference's for every full-width leaf of every config on
  (2, 4), (4, 2), (1, 8), (16, 16) and (2, 16, 16), with and without FSDP
  and in the sp layout; ``spec_for``'s tuple equals ``tuple(PartitionSpec)``.
- ``cache_sharding`` / ``batch_sharding`` specs equal the reference's,
  which builds ``NamedSharding``s and so runs in one subprocess with 8
  forced host devices.
- ``_dense_axes_from_cores`` and ``cache_weights(axes=)`` give the
  reference's axes.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as RC
from repro.analysis.sharding_lint import MeshSpec
from repro.core import engine as RE
from repro.core import layers as RL
from repro.models import model as RM
from repro.parallel import sharding as RS
from repro_torch import configs as TC
from repro_torch.core import engine as TE
from repro_torch.core import layers as TL
from repro_torch.models.model import build, family_module
from repro_torch.parallel import sharding as TS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list(TC.ARCHS)
MESHES = [{"data": 2, "model": 4}, {"data": 4, "model": 2}, {"data": 1, "model": 8},
          {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]
RULE_KINDS = [{"fsdp": True, "sp": False}, {"fsdp": False, "sp": False},
              {"fsdp": True, "sp": True}]


class Standin:
    """A mesh's names and shape, nothing behind them."""

    def __init__(self, sizes: dict):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _ref_tree(cfg):
    """(shapes, axes) of the reference's ``init_params`` at ``cfg``, flat."""
    params, axes = RL.split_annotations(jax.eval_shape(RM.build(cfg).init,
                                                       jax.random.PRNGKey(0)))
    return ({k: tuple(v.shape) for k, v in _flat(params).items()}, _flat(axes))


def _port_tree(cfg):
    """(shapes, axes) of the port's model at ``cfg`` on the meta device."""
    with torch.device("meta"), TL.annotating():
        params, axes = TL.split_annotations(family_module(cfg).init(torch.Generator(), cfg))
    return {k: tuple(v.shape) for k, v in _flat(params).items()}, _flat(axes)


@functools.lru_cache(maxsize=None)
def _full(arch):
    return _ref_tree(RC.get_config(arch)), _port_tree(TC.get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_axes_equal_the_references(arch):
    (_, rax) = _ref_tree(RC.smoke_config(arch))
    tax = _flat(TL.axes_for(TC.smoke_config(arch)))
    assert tax == rax
    assert _flat(build(TC.smoke_config(arch), device="cpu").axes) == rax


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_axes_and_shapes_equal_the_references(arch):
    (rshape, rax), (tshape, tax) = _full(arch)
    assert tax == rax
    assert tshape == rshape


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_specs_equal_the_references_at_full_width(arch):
    (shapes, axes), _ = _full(arch)
    tcfg, rcfg = TC.get_config(arch), RC.get_config(arch)
    checked = 0
    for sizes in MESHES:
        rmesh, tmesh = MeshSpec(sizes), Standin(sizes)
        assert TS.mesh_axis_sizes(tmesh) == RS.mesh_axis_sizes(rmesh)
        for kind in RULE_KINDS:
            rrules = RS.head_safe_rules(RS.make_rules(rmesh, **kind), rcfg, rmesh)
            trules = TS.head_safe_rules(TS.make_rules(tmesh, **kind), tcfg, tmesh)
            assert trules == rrules
            rsizes = RS.mesh_axis_sizes(rmesh)
            for key, ax in axes.items():
                shape = shapes[key]
                assert TS.resolve_dims(ax, shape, trules, rsizes) == \
                    RS.resolve_dims(ax, shape, rrules, rsizes), key
                ref = tuple(RS.spec_for(ax, shape, rrules, rmesh))
                assert TS.spec_for(ax, shape, trules, tmesh) == ref, (key, sizes, kind)
                checked += 1
    assert checked == len(axes) * len(MESHES) * len(RULE_KINDS)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = Standin({"pod": 2, "data": 16, "model": 16})
    assert TS.placements((("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0),
                                                                     Shard(2))
    assert TS.placements((), mesh) == (Replicate(),) * 3
    tree = {"a": torch.zeros(32, 7), "b": {"c": torch.zeros(3)}}
    out = TS.tree_shardings({"a": ("embed", None), "b": {"c": ("embed",)}}, tree, mesh,
                            TS.make_rules(mesh))
    assert out == {"a": (Replicate(), Shard(0), Replicate()),
                   "b": {"c": (Replicate(),) * 3}}


_CACHE_LEAVES = [          # (name, shape, integer)
    ("k", (2, 8, 24, 2, 16), False), ("v", (2, 8, 24, 2, 16), False),
    ("k", (2, 1, 24, 2, 16), False), ("k", (2, 8, 20, 8, 16), False),
    ("k", (2, 8, 20, 3, 16), False), ("pos", (2, 8), True),
    ("k_pages", (2, 16, 8, 2, 16), False), ("v_pages", (2, 16, 6, 4, 16), False),
    ("k_pages", (2, 16, 6, 3, 16), False), ("page_table", (2, 8, 3), True),
    ("free_list", (2, 16), True), ("free_count", (2,), True),
    ("", (24, 8, 24, 128, 64), False), ("", (24, 1, 24, 128, 64), False),
    ("enc_out", (8, 1500, 384), False), ("enc_out", (3, 1500, 384), False),
]
_BATCH_LEAVES = [(8, 128), (1, 128), (4,), (16, 1024, 1152), ()]
_SUB_MESHES = [(2, 4), (4, 2), (1, 8), (8, 1)]


def _nested_caches() -> list:
    """The nested serving caches at full width, as {key: (shape, integer)}
    trees: zamba2-7b's ``{"kv": {k, v, pos}, "ssm"}`` at 8 x 528 and
    whisper-tiny's ``{"self": {k, v, pos}, "enc_out"}`` at 8 x 448."""
    def spec(t):
        if isinstance(t, dict):
            return {k: spec(v) for k, v in t.items()}
        return [list(t.shape), not t.dtype.is_floating_point]
    out = []
    for arch, batch, max_len in (("zamba2-7b", 8, 528), ("whisper-tiny", 8, 448)):
        cfg = TC.get_config(arch)
        out.append(spec(family_module(cfg).init_cache(cfg, batch, max_len, device="meta")))
    return out


@functools.lru_cache(maxsize=None)
def _reference_cache_and_batch_specs():
    code = textwrap.dedent(f"""
        import os, json
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        os.environ["JAX_PLATFORMS"] = "cpu"
        import sys; sys.path.insert(0, "src")
        import jax, jax.numpy as jnp
        from repro.parallel import sharding as S
        out = {{}}
        for shape in {_SUB_MESHES!r}:
            mesh = jax.make_mesh(shape, ("data", "model"))
            rules = S.make_rules(mesh)
            specs = {{}}
            for i, (name, sh, integer) in enumerate({_CACHE_LEAVES!r}):
                sd = jax.ShapeDtypeStruct(sh, jnp.int32 if integer else jnp.bfloat16)
                tree = {{name: sd}} if name else sd
                sharded = S.cache_sharding(tree, mesh, rules)
                sharded = sharded[name] if name else sharded
                specs[f"cache{{i}}"] = [list(p) if isinstance(p, tuple) else p
                                       for p in sharded.spec]
            for i, sh in enumerate({_BATCH_LEAVES!r}):
                b = S.batch_sharding(jax.ShapeDtypeStruct(sh, jnp.int32), mesh, rules)
                specs[f"batch{{i}}"] = [list(p) if isinstance(p, tuple) else p for p in b.spec]
            def sds(t):
                if isinstance(t, dict):
                    return {{k: sds(v) for k, v in t.items()}}
                return jax.ShapeDtypeStruct(tuple(t[0]), jnp.int32 if t[1] else jnp.bfloat16)
            for i, tree in enumerate({_nested_caches()!r}):
                sharded = S.cache_sharding(sds(tree), mesh, rules)
                specs[f"nested{{i}}"] = jax.tree.map(
                    lambda n: [list(p) if isinstance(p, tuple) else p for p in n.spec],
                    sharded, is_leaf=lambda n: hasattr(n, "spec"))
            out[str(shape)] = specs
        print("SPECS" + json.dumps(out))
    """)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=ROOT, timeout=300, env=env)
    line = next((ln for ln in r.stdout.splitlines() if ln.startswith("SPECS")), None)
    assert line, r.stdout[-2000:] + r.stderr[-2000:]
    return json.loads(line[5:])


def _norm(spec) -> tuple:
    parts = [tuple(p) if isinstance(p, list) else p for p in spec]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


@pytest.mark.parametrize("shape", _SUB_MESHES)
def test_cache_and_batch_specs_equal_the_references(shape):
    ref = _reference_cache_and_batch_specs()[str(shape)]
    mesh = Standin({"data": shape[0], "model": shape[1]})
    rules = TS.make_rules(mesh)
    for i, (name, sh, integer) in enumerate(_CACHE_LEAVES):
        assert TS.cache_spec(name, sh, integer, mesh, rules) == _norm(ref[f"cache{i}"]), \
            (name, sh)
        t = torch.zeros(sh, dtype=torch.int32 if integer else torch.bfloat16)
        placed = TS.cache_sharding({name: t} if name else t, mesh, rules)
        placed = placed[name] if name else placed
        assert placed == TS.placements(_norm(ref[f"cache{i}"]), mesh)
    for i, sh in enumerate(_BATCH_LEAVES):
        assert TS.batch_spec(sh, mesh, rules) == _norm(ref[f"batch{i}"]), sh
        assert TS.batch_sharding(torch.zeros(sh), mesh, rules) == \
            TS.placements(_norm(ref[f"batch{i}"]), mesh)


@pytest.mark.parametrize("shape", _SUB_MESHES)
def test_nested_cache_placements_equal_the_references(shape):
    """zamba2-7b's and whisper-tiny's nested caches: every leaf placed by
    its own key as the reference's ``cache_sharding`` places it (K/V over
    the batch and the sequence, positions replicated, the SSM state over
    the batch and its heads, ``enc_out`` over the batch)."""
    ref = _reference_cache_and_batch_specs()[str(shape)]
    mesh = Standin({"data": shape[0], "model": shape[1]})
    rules = TS.make_rules(mesh)

    def tensors(t):
        if isinstance(t, dict):
            return {k: tensors(v) for k, v in t.items()}
        return torch.empty(t[0], dtype=torch.int32 if t[1] else torch.bfloat16,
                           device="meta")

    for i, tree in enumerate(_nested_caches()):
        placed = _flat(TS.cache_sharding(tensors(tree), mesh, rules))
        want = {k: TS.placements(_norm(v), mesh) for k, v in _flat(ref[f"nested{i}"]).items()}
        assert placed == want and len(placed) == 4, (placed, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_axes_from_cores_equal_the_references(arch):
    (_, axes), _ = _full(arch)
    mats = {}
    for key, ax in axes.items():
        if "/cores/" in key:
            mats.setdefault(key.split("/cores/")[0], {})[key.split("/cores/")[1]] = ax
    assert mats
    for key, cores in mats.items():
        names = TL.core_names(len(cores))
        seq = [cores[n] for n in names]
        assert TE._dense_axes_from_cores(seq) == RE._dense_axes_from_cores(seq), key


@pytest.mark.parametrize("arch", ["qwen3-14b", "bert-base", "mamba2-130m"])
def test_cache_weights_axes_equal_the_references(arch):
    """The serving snapshot's axes: each densified W inherits its cores'
    layout, the factorized matrices keep their per-core axes."""
    rmodel = RM.build(RC.smoke_config(arch))
    shapes, raxes = RL.split_annotations(jax.eval_shape(rmodel.init, jax.random.PRNGKey(0)))
    rparams = jax.tree.map(lambda sd: jnp.zeros(sd.shape, sd.dtype), shapes)
    _, rserve = rmodel.cache_weights(rparams, axes=raxes)
    model = build(TC.smoke_config(arch), device="cpu")
    _, tserve = model.cache_weights(model.tree(), axes=model.axes)
    assert _flat(tserve) == _flat(rserve)
