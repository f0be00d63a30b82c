"""Launch metadata of the port's CUDA kernels, recorded without running them
(counterpart of ``repro.kernels.introspect``).

The JAX package reads each ``pallas_call`` out of a traced jaxpr. Here the
step runs on **meta tensors** (shapes, dtypes and strides, no data, no
device) inside :func:`recording`: each kernel wrapper then takes its usual
path, with its checks and its output allocations, up to the launch, where it
appends the :class:`KernelLaunch` it would make and returns its meta outputs
instead of calling the library. The launch and the record take their layout
from the same function (``rmnp_update.split``, ``matmul.k_chunk`` and
``split_blocks``, ``flash_attention.flash_layout``), so the two cannot
disagree; where the C side picks a number itself (the grid of the flash
kernels, the RMNP kernel's ``gridDim.y``), the record mirrors it, and
``chip_smoke.py`` phase K holds every record against the grid, block and
instantiation that ``torch.profiler`` reads on the card.

Outside :func:`recording` a meta tensor reaching a kernel entry raises as
before, and a CUDA tensor takes the same route whether or not a recording is
open: nothing here reroutes one.

:func:`launch_coverage` is the counterpart of ``block_coverage``: the blocks
of a CUDA launch cut each operand into rectilinear tiles (a tile size and a
tile count along every dimension, the counts read off the grid), and the
check is that the tiles cover every element and that none starts wholly out
of bounds. The kernels mask their ragged edges where the TPU kernels pad,
so a last tile that runs past the edge is covered, not an error.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

# a block may use this much dynamic shared memory on an H100 (227 KB opt-in)
SMEM_LIMIT = 232448
MAX_CLUSTER = 16          # above 8 only with the non-portable attribute
MAX_THREADS = 1024        # a block's threads
MAX_GRID = (2 ** 31 - 1, 65535, 65535)


class Operand(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    dtype: str
    strides: Tuple[int, ...]

    @classmethod
    def of(cls, name: str, t: torch.Tensor) -> "Operand":
        return cls(name, tuple(t.shape), str(t.dtype).replace("torch.", ""),
                   tuple(t.stride()))


class Tiling(NamedTuple):
    """How a launch's blocks cut one operand, seen as ``shape`` (the
    kernel's own view, e.g. the flattened ``(L, d_in, d_out)`` stack):
    ``count[d]`` tiles of ``tile[d]`` elements along dimension ``d``,
    starting at multiples of ``tile[d]``."""
    operand: str
    shape: Tuple[int, ...]
    tile: Tuple[int, ...]
    count: Tuple[int, ...]


class KernelLaunch(NamedTuple):
    name: str                        # its ``LAUNCHES`` key
    kernel: str                      # the CUDA function template
    template: Tuple[str, ...]        # its arguments, as the demangled name spells them
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    cluster: Tuple[int, int, int]
    smem_bytes: int                  # dynamic shared memory a block
    operands: Tuple[Operand, ...]
    tiles: Tuple[Tiling, ...]
    layout: Any = None               # the Python layout it was built from (a ``Split``, ...)
    # what the launch's cost counts that its operands do not show, as
    # (key, value) pairs: a flash launch's ``causal``, the input elements a
    # GEMM reads once (``reads``: an operand passed twice, or beside its own
    # transpose, is read once); ``launch/cost.kernel_cost`` reads them
    work: Tuple[Tuple[str, Any], ...] = ()

    @property
    def signature(self) -> str:
        """``rmnp_kernel<64, true, true, float, __nv_bfloat16>``, as a
        demangled kernel name shows the instantiation."""
        return f"{self.kernel}<{', '.join(self.template)}>"


_ACTIVE: contextvars.ContextVar[Optional[List[KernelLaunch]]] = contextvars.ContextVar(
    "repro_torch_kernel_launches", default=None)


@contextlib.contextmanager
def recording() -> Iterator[List[KernelLaunch]]:
    """Inside, a kernel entry given meta tensors records its launch (in the
    yielded list, in launch order) and returns meta outputs."""
    launches: List[KernelLaunch] = []
    token = _ACTIVE.set(launches)
    try:
        yield launches
    finally:
        _ACTIVE.reset(token)


def tracing(t: torch.Tensor) -> bool:
    """Whether ``t`` is a meta tensor inside :func:`recording`: the one case
    in which a kernel wrapper records its launch instead of making it."""
    return t.is_meta and _ACTIVE.get() is not None


def record(launch: KernelLaunch) -> None:
    launches = _ACTIVE.get()
    if launches is None:
        raise RuntimeError("a kernel launch was recorded outside introspect.recording()")
    launches.append(launch)


def to_meta(tree):
    """``tree`` with every tensor replaced by a meta tensor of its shape,
    dtype and strides (dicts, lists, tuples and NamedTuples rebuilt)."""
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tuple(tree.shape), tuple(tree.stride()),
                                   dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return type(tree)((k, to_meta(v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_meta(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_meta(v) for v in tree)
    return tree


def collect_kernel_launches(fn, *args, **kwargs) -> List[KernelLaunch]:
    """Run ``fn`` on meta copies of its tensor arguments under
    :func:`recording` and return every launch it would make, in order.
    Nothing is allocated on a device and no kernel is built."""
    with recording() as launches:
        fn(*to_meta(args), **to_meta(kwargs))
    return list(launches)


def launch_coverage(launch: KernelLaunch) -> Dict[str, Any]:
    """Per operand and dimension, whether the launch's tiles cover ``[0,
    extent)`` and whether a tile starts at or past the extent (wholly out of
    bounds). Returns ``{"uncovered": [(operand, dim, gap_start, gap_end)],
    "out_of_bounds": [(operand, dim, start)], "covers": bool}``."""
    uncovered: List[Tuple[str, int, int, int]] = []
    out_of_bounds: List[Tuple[str, int, int]] = []
    for t in launch.tiles:
        for d, (n, tile, count) in enumerate(zip(t.shape, t.tile, t.count, strict=True)):
            covered_to = tile * count
            if covered_to < n:
                uncovered.append((t.operand, d, covered_to, n))
            if count and tile * (count - 1) >= n:
                out_of_bounds.append((t.operand, d, tile * (count - 1)))
    return {"uncovered": uncovered, "out_of_bounds": out_of_bounds,
            "covers": not uncovered and not out_of_bounds}


def new_storage_outputs(func, out) -> List[torch.Tensor]:
    """The tensors among ``func``'s outputs that own new storage: every
    output its schema does not mark as aliasing an input (a view or an
    in-place result allocates nothing)."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    returns = func._schema.returns
    fresh = []
    for i, t in enumerate(outs):
        if not isinstance(t, torch.Tensor):
            continue
        info = returns[min(i, len(returns) - 1)].alias_info if returns else None
        if info is None:
            fresh.append(t)
    return fresh


def op_name(func) -> str:
    """``cat`` for ``aten.cat.default``."""
    return func.overloadpacket.__name__
