"""Op counting for the dry-run roofline — the port's counterpart of
``repro.launch.hlo_analysis``.

The reference parses the compiled HLO text of a step: XLA's
``cost_analysis`` counts a scanned (while-loop) layer stack's body once,
so that module walks the call graph and multiplies each body by its trip
count.  Eager torch has no compiled module to parse and needs no such
correction: each iteration of a Python loop over layers dispatches its ops
anew, so counting every op a step dispatches counts each layer.  ``OpCounter``
is a ``TorchDispatchMode`` that does so over one step, per rank (a DTensor's
op is counted on its local block):

* matmul FLOPs — ``torch.utils.flop_counter``'s formulas (the same that
  ``FlopCounterMode`` applies: mm, bmm, addmm, baddbmm, convolutions,
  attention), per op;
* bytes written — every output of every op that is not a view (the
  reference's ``hlo_bytes_written`` proxy; eager torch writes each output to
  memory, so on the card it is a floor of a step's writes, not a bound);
* matmul bytes — operands and outputs of the matmuls (the reference's
  ``hlo_dot_bytes`` convention for the memory term);
* collective bytes per kind — the result of every ``c10d`` and
  ``_c10d_functional`` all-gather, all-reduce, reduce-scatter and
  all-to-all (what the op leaves in this rank's buffers);
* the peak of live bytes — the storages alive at once, the inputs it was
  told of (``track``) and every storage an op creates, freed when torch
  frees them.

The hand-written CUDA kernels' work enters through their plain versions'
ops: a count is taken on CPU tensors (the dry run's fake ones), where each
kernel wrapper calls its plain PyTorch version, so the FLOPs are the plain
version's matmuls (the same products the kernel computes) and the bytes its
intermediates (which the kernel keeps in shared memory and registers).
"""

from __future__ import annotations

import collections
import weakref

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
_KIND = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
}
_COLLECTIVE_NS = ("c10d", "_c10d_functional")


def _local(x):
    """A DTensor's local block; anything else as it is."""
    return getattr(x, "_local_tensor", x)


def _tensors(tree) -> list:
    return [_local(t) for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def collective_kind(func) -> str | None:
    """The collective kind of an op, or None."""
    ns = func.namespace
    if ns not in _COLLECTIVE_NS:
        return None
    return _KIND.get(func._schema.name.split("::", 1)[-1])


class OpCounter(TorchDispatchMode):
    """Counts one step's work as the module docstring says.  Example::

        with FakeTensorMode():
            x, w = torch.empty(64, 128), torch.empty(128, 32)
            counter = OpCounter()
            counter.track((x, w))
            with counter:
                y = x @ w
        counter.summary()["flops"]      # 2 * 64 * 128 * 32
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_by_op: collections.Counter = collections.Counter()
        self.bytes_written = 0
        self.matmul_bytes = 0
        self.collective_bytes = {k: 0 for k in COLLECTIVES}
        self.ops: collections.Counter = collections.Counter()
        self.live = 0
        self.peak = 0
        self._storages: set = set()

    # ---- live bytes ----

    def _free(self, key, nbytes):
        self._storages.discard(key)
        self.live -= nbytes

    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live from now on (a
        step's parameters, optimizer state and batch)."""
        for t in _tensors(tree):
            if t.layout != torch.strided:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            self._storages.add(key)
            n = st.nbytes()
            self.live += n
            weakref.finalize(st, self._free, key, n)
        self.peak = max(self.peak, self.live)

    # ---- dispatch ----

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops[str(func)] += 1
        packet = func._overloadpacket
        outs = _tensors(out)
        if packet in flop_registry:
            largs, lkw, lout = pytree.tree_map(_local, (args, kwargs, out))
            f = int(flop_registry[packet](*largs, **lkw, out_val=lout))
            self.flops += f
            self.flops_by_op[str(packet)] += f
            self.matmul_bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)) + outs)
        kind = collective_kind(func)
        if kind is not None:
            self.collective_bytes[kind] += sum(_nbytes(t) for t in outs)
        if not func.is_view and func.namespace not in _COLLECTIVE_NS:
            self.bytes_written += sum(_nbytes(t) for t in outs)
        self.track(outs)
        return out

    def summary(self) -> dict:
        return {"flops": self.flops, "flops_by_op": dict(self.flops_by_op),
                "bytes_written": self.bytes_written, "matmul_bytes": self.matmul_bytes,
                "collective_bytes": dict(self.collective_bytes),
                "peak_bytes": self.peak, "ops": sum(self.ops.values())}


def analyze(fn, *args, inputs=None, **kwargs):
    """``(fn(*args, **kwargs), counts)``: one call under ``OpCounter``,
    with ``inputs`` (default: the arguments) counted live from the start."""
    counter = OpCounter()
    counter.track((args, kwargs) if inputs is None else inputs)
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.summary()
