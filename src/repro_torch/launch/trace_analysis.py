"""What one rank's step does, counted as it runs: the counterpart of the
JAX package's ``launch/hlo_analysis.py``.

The reference reads XLA's compiled HLO text: it splits the module into
computations, recovers each while loop's trip count from its
``known_trip_count`` and multiplies the dots and collectives of a loop
body by it, since XLA's own cost analysis counts a body once. The port
runs its layers, query chunks and recurrence chunks in Python loops, so
every op reaches the dispatcher as often as it runs and no trip count
needs recovering: ``StepTrace``, a ``TorchDispatchMode`` around one
step, counts each op once each time it runs. Activation checkpointing
(``remat_blocks``) re-dispatches the forward in the backward, so its
recompute is counted as XLA's is. The reference's HLO-text parsing
(``parse_module``, ``dryrun.parse_collective_bytes``) has no counterpart.

Counted, per rank:
  * ``flops_dot``: 2 * M * N * K of every matrix product (``mm``,
    ``bmm``, ``addmm``, ``baddbmm``, ``mv``, ``dot``, and so every
    ``matmul``, ``linear`` and ``einsum`` that lowers to them), as
    ``torch.utils.flop_counter`` counts them; ``dot_count`` the number
    of such products run (the reference's counts each dot instruction of
    the text once);
  * the operand bytes of every collective (``c10d`` ops) by the
    reference's five kinds; ``collective_counts_dynamic`` counts each
    call, ``collective_counts_static`` each distinct call site in the
    source (a file and line outside torch);
  * memory, by a tracker of its own (not ``MemTracker``): every storage
    an op returns is live from then until it is freed (a finalizer on
    the storage), and the step's ``argument`` bytes (the distinct
    storages of the tensors given to ``StepTrace``) are live throughout.
    ``peak`` is ``argument`` plus the high-water mark of the bytes the
    step allocated and held at once, ``temp`` that high-water mark, and
    ``output`` the bytes of the storages the step returned that it
    allocated. It sees what the dispatcher sees: the caching allocator's
    rounding (to 512 bytes), the CUDA context, cuBLAS's workspaces and
    an op's internal scratch are not in it.

The hand-written kernels (``kernels/ops.py``) are not aten products, so
each entry that launches one reports the work of the plain version it
stands for (``count_kernel``: that plain version replayed on ``meta``
tensors of the same shapes, once a signature); where the entry runs the
plain version itself (CPU and ``meta`` tensors) its products are counted
as they run (``plain_kernel``). A trace of a step on ``meta`` and one of
the same step on the card then count the same.
"""
from __future__ import annotations

import contextlib
import os
import sys
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten


def _mnk_mm(a, b, *_):
    return a.shape[0], b.shape[1], a.shape[1]


def _mnk_bmm(a, b, *_):
    return a.shape[0] * a.shape[1], b.shape[2], a.shape[2]


# aten product -> (M, N, K) of its operands' shapes (batch folded into M)
_PRODUCTS = {
    _aten.mm.default: _mnk_mm,
    _aten.bmm.default: _mnk_bmm,
    _aten.addmm.default: lambda c, a, b, *_: _mnk_mm(a, b),
    _aten.baddbmm.default: lambda c, a, b, *_: _mnk_bmm(a, b),
    _aten.mv.default: lambda a, x, *_: (a.shape[0], 1, a.shape[1]),
    _aten.dot.default: lambda a, b, *_: (1, 1, a.shape[0]),
}

# c10d op -> (kind, index of its operand argument)
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_base_": ("all-to-all", 1),
    "alltoall_": ("all-to-all", 1),
    "send": ("collective-permute", 0),
}

_TORCH_DIR = os.path.dirname(torch.__file__)
_HERE = os.path.abspath(__file__)

# the traces open in this process, innermost last: process-wide, not a
# thread's, since autograd runs a CUDA backward (and remat's recompute,
# which reaches the kernel entries) on a device thread of its own
_ACTIVE: List["StepTrace"] = []


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _call_site() -> Tuple[str, int]:
    """The innermost frame outside torch and this module."""
    f = sys._getframe(2)
    while f is not None:
        name = os.path.abspath(f.f_code.co_filename)
        if not name.startswith(_TORCH_DIR) and name != _HERE:
            return name, f.f_lineno
        f = f.f_back
    return "?", 0


class StepTrace(TorchDispatchMode):
    """Counts one rank's step (module note). ``arguments``: the step's
    inputs (any tree of tensors), whose storages are live throughout;
    ``memory=False`` counts work only. ``result(outputs)`` gives the
    figures; ``kernel_work`` the work each hand-written kernel's entry
    reported, by name: ``[calls, flops, dots]``."""

    def __init__(self, arguments=None, *, memory: bool = True):
        super().__init__()
        self.memory = memory
        self.flops = 0
        self.dots = 0
        self.coll: Dict[str, int] = dict.fromkeys(COLLECTIVES, 0)
        self.dynamic: Dict[str, int] = dict.fromkeys(COLLECTIVES, 0)
        self.sites: Dict[str, set] = {k: set() for k in COLLECTIVES}
        self.kernel_work: Dict[str, List[int]] = {}
        self._args: set = set()
        self.argument = 0
        for t in _tensors(arguments):
            self._hold_argument(t)
        self._owned: Dict[int, int] = {}   # id(storage) -> bytes
        self._live = 0
        self.temp = 0

    # ------------------------------------------------------------ memory
    def _hold_argument(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if id(st) not in self._args:
            self._args.add(id(st))
            self.argument += st.nbytes()
            # a storage's Python object lives as long as the storage; its
            # id leaves the set when it is freed, so a later storage that
            # reuses the id counts as the step's own
            weakref.finalize(st, self._args.discard, id(st))

    def _freed(self, key: int, nbytes: int) -> None:
        if self._owned.pop(key, None) is not None:
            self._live -= nbytes

    def _hold(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._owned or key in self._args:
                continue
            n = st.nbytes()
            self._owned[key] = n
            self._live += n
            weakref.finalize(st, self._freed, key, n)
        self.temp = max(self.temp, self._live)

    # ------------------------------------------------------------ counting
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        mnk = _PRODUCTS.get(func)
        if mnk is not None:
            m, n, k = mnk(*args)
            self.flops += 2 * m * n * k
            self.dots += 1
        elif func.namespace == "c10d":
            kind = _C10D.get(func.__name__.split(".")[0])
            if kind is not None:
                name, i = kind
                self.coll[name] += sum(_nbytes(t)
                                       for t in _tensors(args[i]))
                self.dynamic[name] += 1
                self.sites[name].add(_call_site())
        if self.memory:
            self._hold(out)
        return out

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def add_kernel(self, name: str, flops: int, dots: int,
                   counted: bool) -> None:
        """Record a kernel entry's work; ``counted`` where its products
        were already counted as they ran (the plain version in place)."""
        w = self.kernel_work.setdefault(name, [0, 0, 0])
        w[0] += 1
        w[1] += flops
        w[2] += dots
        if not counted:
            self.flops += flops
            self.dots += dots

    def result(self, outputs=None) -> Dict:
        """The reference's keys (``hlo_analysis.analyze``) and the
        memory figures in bytes."""
        out = 0
        seen = set()
        for t in _tensors(outputs):
            st = t.untyped_storage()
            if id(st) in self._owned and id(st) not in seen:
                seen.add(id(st))
                out += st.nbytes()
        return {
            "flops_dot": float(self.flops),
            "dot_count": self.dots,
            "collective_bytes": {k: float(v) for k, v in self.coll.items()},
            "collective_bytes_total": float(sum(self.coll.values())),
            "collective_counts_static": {k: len(v)
                                         for k, v in self.sites.items()},
            "collective_counts_dynamic": dict(self.dynamic),
            "kernel_work": {k: {"calls": c, "flops": float(f), "dots": d}
                            for k, (c, f, d) in self.kernel_work.items()},
            "bytes": {"argument": self.argument, "output": out,
                      "temp": self.temp,
                      "peak": self.argument + self.temp},
        }


def active() -> Optional[StepTrace]:
    return _ACTIVE[-1] if _ACTIVE else None


def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device="meta")
    return x


def _signature(x):
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.dtype)
    return x


_REPLAYED: Dict[tuple, Tuple[int, int]] = {}


def count_kernel(name: str, plain: Callable, *args, **kw) -> None:
    """Report to the active trace (if any) the work of ``plain(*args,
    **kw)``, the plain version of the kernel ``name`` that is about to
    launch on these arguments: ``plain`` replayed on ``meta`` tensors of
    their shapes outside every trace, once a signature."""
    tr = active()
    if tr is None:
        return
    key = (name, plain, tuple(_signature(a) for a in args),
           tuple(sorted((k, _signature(v)) for k, v in kw.items())))
    work = _REPLAYED.get(key)
    if work is None:
        with _disable_current_modes(), torch.no_grad():
            sub = StepTrace(memory=False)
            with sub:
                plain(*(_meta(a) for a in args),
                      **{k: _meta(v) for k, v in kw.items()})
        work = _REPLAYED[key] = (sub.flops, sub.dots)
    tr.add_kernel(name, work[0], work[1], counted=False)


@contextlib.contextmanager
def plain_kernel(name: str):
    """Around the plain version of the kernel ``name`` run in its place
    (CPU or ``meta`` tensors): its products count as they run, and are
    recorded under ``name`` too."""
    tr = active()
    if tr is None:
        yield
        return
    f0, d0 = tr.flops, tr.dots
    yield
    tr.add_kernel(name, tr.flops - f0, tr.dots - d0, counted=True)


def trace(fn: Callable, *args, memory: bool = True, **kw):
    """``(fn(*args, **kw), figures)``: one call of ``fn`` under a
    ``StepTrace`` whose arguments are ``args`` and ``kw``."""
    with StepTrace((args, kw), memory=memory) as tr:
        out = fn(*args, **kw)
    return out, tr.result(out)

