"""The spatial mesh axis over ``torch.distributed`` (counterpart of the spatial half of
:mod:`ssds_tpu.parallel.sharding`).

The JAX package trains on a 2-D ``Mesh(('data', 'spatial'))`` when
``TPU.MESH.SPATIAL > 1``: the images are placed ``P('data', 'spatial')``, so
each chip holds a band of image rows, and GSPMD inserts halo exchanges around
every conv and pool. Here the same layout runs as ``W = D x S`` processes
(``torch.distributed.run``): rank ``r`` is data group ``r // S`` and spatial
index ``r % S``, JAX's ``reshape(data, spatial)`` order. The ``S`` ranks of a
data group load the same images; each keeps a band of the rows of every
activation, and the bands are exchanged where a layer needs its neighbours'
rows.

One generic mechanism, no code per model (:func:`partition`):

- **Layer geometry.** Every layer whose output row ``o`` reads a contiguous
  window of input rows carries its rows' geometry, measured once by a
  forward on the ``meta`` device: each ``nn.Conv2d`` and ``nn.MaxPool2d``
  and YOLOv2's reorg (:class:`~ssds_tpu_torch.models.heads.yolo.Reorg`, a
  2-row window of stride 2) a :class:`RowGeometry` (the global input
  height, kernel, stride, padding, dilation, ``ceil_mode``), and each
  bilinear resize (:class:`~ssds_tpu_torch.models.layers.Resize`: FSSD's
  fusion, YOLOv3's upsamples) a :class:`WindowGeometry` (the global input
  and output heights and each output row's window, read off the resize's
  weight matrix, with no padding row). Its forward is swapped in place (the
  parameter and buffer names do not change) for one that, inside
  :func:`active`, computes only the output rows this rank owns: a conv or
  a pool pads its rows itself (zero rows for a conv and -inf rows for a max
  pool, at the global top and bottom edges only); a resize, a small
  contraction, places the fetched rows in a zero map of the whole height
  and keeps its rows of that map's resize, the whole map's rows bit for
  bit.
- **Row ownership.** Each map's rows are split over the ``S`` ranks as
  ``torch.tensor_split`` splits them (:func:`row_split`); deep maps are
  uneven and a rank may own no row of one, yet joins every exchange.
- **Row fetch.** :class:`_FetchRows` brings the rows a layer's windows need
  from the ranks that own them; its backward sends each fetched row's
  gradient back to its owner, which adds it to its own.
- **Head gather.** The last conv of each predictor (a model's
  ``predictors`` declaration, as YOLO's ``conf0`` ..., else the SSD
  family's ``loc`` / ``conf``) gathers its output over the spatial group in
  global row order (:class:`_GatherRows`), so the priors keep their (h, w,
  anchor) order and the loss runs on whole images, the same on the ``S``
  ranks; the gather's backward keeps this rank's rows of the gradient.

Everything else is pointwise on a band and stays local: activations,
L2Norm, residual adds, channel concatenations of maps of one height (split
alike) and the train-mode BatchNorm, whose statistics sum
``(count, sum x, sum x^2)`` over every rank with this rank's own pixels
(:class:`ssds_tpu_torch.models.layers._GlobalBatchNorm`). The train step
(:func:`ssds_tpu_torch.solver.build_train_step`) cuts the image rows, counts
each image's positives once and reduces the gradients itself.

Transfers are point-to-point (:func:`_exchange`): ``batch_isend_irecv`` of
device tensors on NCCL (a card a rank), and on gloo, which sends host
tensors only, staged through the host. Every family of the port splits;
an image height that does not divide by ``S`` raises, and a layer that
cannot be split raises at :func:`partition` (nothing falls back to a whole
map on one rank).
"""

from __future__ import annotations

import contextlib
import copy
import functools
import itertools
import threading
from dataclasses import dataclass
from typing import Callable, ClassVar, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ssds_tpu_torch.models.heads.yolo import Reorg
from ssds_tpu_torch.models.layers import Resize, _resize_weights

# transfers since the last reset: halo rows (forward and backward) and the head gather
counters = {"halo_messages": 0, "halo_bytes": 0, "gather_messages": 0, "gather_bytes": 0}


def reset_counters() -> None:
    for k in counters:
        counters[k] = 0


def row_split(n: int, parts: int) -> List[Tuple[int, int]]:
    """``[start, end)`` of each part of ``n`` rows, as ``torch.tensor_split``
    splits them (the first ``n % parts`` parts one row longer)."""
    q, r = divmod(n, parts)
    out, start = [], 0
    for i in range(parts):
        end = start + q + (1 if i < r else 0)
        out.append((start, end))
        start = end
    return out


def check_model(model_cfg, spatial: int) -> None:
    """What the JAX package checks: an image height that does not divide by
    ``spatial`` raises its ``ValueError``
    (``ssds_tpu/parallel/sharding.py:134-140``)."""
    check_height(int(model_cfg.IMAGE_SIZE[0]), spatial)


def check_height(height: int, spatial: int) -> None:
    if spatial > 1 and height % spatial != 0:
        raise ValueError(f"image height {height} not divisible by the spatial mesh axis "
                         f"({spatial}); pick TPU.MESH.SPATIAL dividing H")


# --------------------------------------------------------------------------
# Geometry and routes
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class RowGeometry:
    """A conv's or a max pool's rows: the global input ``height`` and the
    height axis's kernel, stride, padding and dilation; ``pad`` is the value
    of a padding row (0 for a conv, -inf for a max pool)."""

    height: int
    kernel: int
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    ceil_mode: bool = False
    pad: float = 0.0

    @property
    def span(self) -> int:
        return self.dilation * (self.kernel - 1) + 1

    @property
    def out_height(self) -> int:
        """PyTorch's output height, ``ceil_mode``'s rule included."""
        room = self.height + 2 * self.padding - self.span
        if not self.ceil_mode:
            return room // self.stride + 1
        out = -(-room // self.stride) + 1
        if (out - 1) * self.stride >= self.height + self.padding:
            out -= 1  # the last window must start inside the image or the top padding
        return out

    @property
    def local(self) -> bool:
        """Whether each output row needs only the input row of its own index
        (a 1x1 stride-1 unpadded layer): no transfer, no padding."""
        return self.span == 1 and self.stride == 1 and self.padding == 0

    @property
    def idle(self) -> int:
        """The padding rows a rank with no output row computes: one window
        (a conv refuses fewer rows than its kernel)."""
        return self.span

    def reads(self, o0: int, o1: int) -> Tuple[int, int]:
        """The input rows ``[lo, hi)`` (possibly outside ``[0, height)``:
        padding) that the output rows ``[o0, o1)``, ``o1 > o0``, read."""
        return o0 * self.stride - self.padding, (o1 - 1) * self.stride - self.padding + self.span


@dataclass(frozen=True)
class WindowGeometry:
    """A resampling layer's rows: output row ``o`` of ``out_height`` reads
    the input rows ``windows[o] = [first, last + 1)`` of ``height``, never a
    padding row; the windows' ends do not fall as ``o`` grows."""

    height: int
    out_height: int
    windows: Tuple[Tuple[int, int], ...]
    pad: ClassVar[float] = 0.0  # no padding row is made
    idle: ClassVar[int] = 0  # a rank with no output row reads no row

    def __post_init__(self):
        starts, ends = zip(*self.windows)
        if len(self.windows) != self.out_height or list(starts) != sorted(starts) \
                or list(ends) != sorted(ends) or starts[0] < 0 or ends[-1] > self.height \
                or any(a >= b for a, b in self.windows):
            raise ValueError(f"not a window geometry: {self}")

    @classmethod
    def bilinear(cls, height: int, out_height: int) -> "WindowGeometry":
        """The rows of :func:`resize_bilinear` from ``height`` to
        ``out_height`` rows: each output row's nonzero weights."""
        nonzero = _resize_weights(height, out_height) != 0  # [height, out_height]
        first = nonzero.argmax(axis=0)
        last = height - 1 - nonzero[::-1].argmax(axis=0)
        return cls(height, out_height, tuple(zip(first.tolist(), (last + 1).tolist())))

    @property
    def local(self) -> bool:
        """Whether each output row reads only the input row of its own index."""
        return self.windows == tuple((o, o + 1) for o in range(self.height))

    def reads(self, o0: int, o1: int) -> Tuple[int, int]:
        """The input rows ``[lo, hi)`` that the output rows ``[o0, o1)``,
        ``o1 > o0``, read."""
        return self.windows[o0][0], self.windows[o1 - 1][1]


Geometry = Union[RowGeometry, WindowGeometry]


@dataclass(frozen=True)
class Route:
    """One rank's transfers for one layer.

    ``own`` is this rank's input rows; ``top`` / ``bottom`` the padding rows
    around the fetched rows; ``pieces`` the fetched rows in order, each
    ``(owner, start, end)`` in global input rows (the owner may be this
    rank); ``sends`` this rank's rows that another rank needs, each
    ``(peer, start, end)``; ``empty``: this rank owns no output row (it
    computes ``geom.idle`` rows of padding and keeps none of it)."""

    own: Tuple[int, int]
    top: int
    bottom: int
    pieces: Tuple[Tuple[int, int, int], ...]
    sends: Tuple[Tuple[int, int, int], ...]
    empty: bool


def _need(geom: Geometry, out_rows: Tuple[int, int]) -> Tuple[int, int]:
    """The input rows ``[lo, hi)`` (possibly outside ``[0, height)``) that
    the output rows ``[o0, o1)`` read; ``(0, 0)`` for no output row."""
    o0, o1 = out_rows
    return geom.reads(o0, o1) if o1 > o0 else (0, 0)


@functools.lru_cache(maxsize=None)
def route(geom: Geometry, size: int, index: int) -> Route:
    """Rank ``index``'s route for ``geom`` among ``size`` spatial ranks."""
    owners = row_split(geom.height, size)
    outs = row_split(geom.out_height, size)

    def real(rank):
        lo, hi = _need(geom, outs[rank])
        return max(lo, 0), min(hi, geom.height)

    own = owners[index]
    lo, hi = _need(geom, outs[index])
    empty = outs[index][0] == outs[index][1]
    if empty:  # a conv's window of padding keeps the layer in the graph
        top, bottom, a, b = geom.idle, 0, 0, 0
    else:
        a, b = real(index)
        top, bottom = a - lo, hi - b
    pieces = tuple((r, max(a, s), min(b, e)) for r, (s, e) in enumerate(owners)
                   if max(a, s) < min(b, e))
    sends = []
    for peer in range(size):
        if peer == index or outs[peer][0] == outs[peer][1]:
            continue
        pa, pb = real(peer)
        s, e = max(pa, own[0]), min(pb, own[1])
        if s < e:
            sends.append((peer, s, e))
    return Route(own, top, bottom, pieces, tuple(sends), empty)


# --------------------------------------------------------------------------
# The plan and its transfers
# --------------------------------------------------------------------------


@dataclass
class SpatialPlan:
    """This rank's place on the ``D x S`` layout: ``size`` (S) spatial ranks a
    data group, ``index`` (s) this rank's, ``ranks`` the group's global ranks
    by spatial index. ``exchange`` moves tensors between them (default
    :func:`_exchange`; the CPU tests put an in-process one here)."""

    size: int
    index: int
    ranks: Tuple[int, ...]
    exchange: Optional[Callable] = None

    @classmethod
    def for_rank(cls, rank: int, world: int, size: int) -> "SpatialPlan":
        if world % size:
            raise ValueError(f"{world} ranks do not divide by TPU.MESH.SPATIAL={size}")
        base = rank - rank % size
        return cls(size, rank % size, tuple(range(base, base + size)))

    def rows(self, height: int) -> Tuple[int, int]:
        """This rank's ``[start, end)`` of ``height`` rows."""
        return row_split(height, self.size)[self.index]

    def transfer(self, sends, recvs, like: torch.Tensor, kind: str) -> List[torch.Tensor]:
        """Send each ``(peer, tensor)`` of ``sends`` and receive, for each
        ``(peer, rows)`` of ``recvs``, a tensor of ``like``'s shape but for
        ``rows`` rows (dim 2); counted under ``kind`` (``halo`` / ``gather``)."""
        counters[f"{kind}_messages"] += len(sends)
        counters[f"{kind}_bytes"] += sum(t.numel() * t.element_size() for _, t in sends)
        shape = lambda n: (like.shape[0], like.shape[1], n, like.shape[3])  # noqa: E731
        exchange = self.exchange or _exchange
        return exchange([(self.ranks[p], t.contiguous()) for p, t in sends],
                        [(self.ranks[p], shape(n)) for p, n in recvs], like)


def _exchange(sends, recvs, like: torch.Tensor) -> List[torch.Tensor]:
    """Point-to-point transfers between global ranks: ``sends`` is ``[(rank,
    tensor)]``, ``recvs`` ``[(rank, shape)]``; returns the received tensors
    on ``like``'s device and dtype. One ``batch_isend_irecv``, waited on. On
    NCCL the device tensors travel as they are; gloo sends host tensors
    only, so a CUDA tensor is staged through the host."""
    if not sends and not recvs:
        return []
    staged = like.is_cuda and dist.get_backend() != "nccl"
    where = torch.device("cpu") if staged else like.device
    ops = [dist.P2POp(dist.isend, t.to(where), peer) for peer, t in sends]
    bufs = [torch.empty(shape, dtype=like.dtype, device=where) for _, shape in recvs]
    ops += [dist.P2POp(dist.irecv, buf, peer) for buf, (peer, _) in zip(bufs, recvs)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [b.to(like.device) for b in bufs] if staged else bufs


class _FetchRows(torch.autograd.Function):
    """``x`` (this rank's rows ``route.own`` of a map) -> the rows that this
    rank's output windows read, with the padding rows around them."""

    @staticmethod
    def forward(ctx, x, route: Route, plan: SpatialPlan, pad: float):
        a0 = route.own[0]
        got = iter(plan.transfer([(p, x[:, :, s - a0:e - a0]) for p, s, e in route.sends],
                                 [(r, e - s) for r, s, e in route.pieces if r != plan.index],
                                 x, "halo"))
        parts = []
        if route.top:
            parts.append(x.new_full((x.shape[0], x.shape[1], route.top, x.shape[3]), pad))
        for r, s, e in route.pieces:
            parts.append(x[:, :, s - a0:e - a0] if r == plan.index else next(got))
        if route.bottom:
            parts.append(x.new_full((x.shape[0], x.shape[1], route.bottom, x.shape[3]), pad))
        ctx.route, ctx.plan, ctx.shape = route, plan, x.shape
        if not parts:  # a resize's rank with no output row reads no row
            return x.new_zeros((x.shape[0], x.shape[1], 0, x.shape[3]))
        return torch.cat(parts, dim=2)

    @staticmethod
    def backward(ctx, g):
        route, plan = ctx.route, ctx.plan
        a0 = route.own[0]
        back, mine, at = [], None, route.top
        for r, s, e in route.pieces:
            piece = g[:, :, at:at + e - s]
            if r == plan.index:
                mine = (s, e, piece)
            else:
                back.append((r, piece))
            at += e - s
        got = plan.transfer(back, [(p, e - s) for p, s, e in route.sends], g, "halo")
        dx = g.new_zeros(ctx.shape)
        if mine is not None:
            dx[:, :, mine[0] - a0:mine[1] - a0] += mine[2]
        for (_, s, e), t in zip(route.sends, got):
            dx[:, :, s - a0:e - a0] += t
        return dx, None, None, None


class _GatherRows(torch.autograd.Function):
    """This rank's rows of a map of ``height`` rows -> the whole map, on
    every rank of the spatial group; the backward keeps this rank's rows of
    the (identical) gradient."""

    @staticmethod
    def forward(ctx, y, height: int, plan: SpatialPlan):
        bounds = row_split(height, plan.size)
        peers = [p for p in range(plan.size) if p != plan.index]
        sends = [(p, y) for p in peers] if y.shape[2] else []  # every rank takes the whole map
        got = iter(plan.transfer(sends, [(p, bounds[p][1] - bounds[p][0]) for p in peers
                                         if bounds[p][1] > bounds[p][0]], y, "gather"))
        parts = [y if p == plan.index else next(got) for p in range(plan.size)
                 if bounds[p][1] > bounds[p][0]]
        ctx.rows = bounds[plan.index]
        return torch.cat(parts, dim=2) if parts else y

    @staticmethod
    def backward(ctx, g):
        return g[:, :, ctx.rows[0]:ctx.rows[1]], None, None


def fetch_rows(x: torch.Tensor, geom: Geometry, plan: SpatialPlan) -> Tuple[torch.Tensor, bool]:
    """``(rows, empty)``: the rows ``geom``'s windows need on this rank, fetched
    from their owners and padded at the global edges; ``empty`` when this
    rank owns no output row (``rows`` is then ``geom.idle`` rows of padding)."""
    r = route(geom, plan.size, plan.index)
    return _FetchRows.apply(x, r, plan, geom.pad), r.empty


def gather_rows(y: torch.Tensor, height: int, plan: SpatialPlan) -> torch.Tensor:
    """The whole map of ``height`` rows from every rank's band of it."""
    return _GatherRows.apply(y, height, plan)


# --------------------------------------------------------------------------
# The model's layers
# --------------------------------------------------------------------------

_LOCAL = threading.local()  # .plan: the plan of this thread's partitioned forward


def _plan() -> Optional[SpatialPlan]:
    return getattr(_LOCAL, "plan", None)


@contextlib.contextmanager
def active(plan: Optional[SpatialPlan]):
    """Run the partitioned layers of every model on ``plan``'s bands inside,
    in this thread (nothing changes for ``None``); outside, they are the
    plain layers."""
    before = _plan()
    _LOCAL.plan = plan if plan is not None else before
    try:
        yield
    finally:
        _LOCAL.plan = before


def _conv_rows(module: nn.Conv2d, x, weight, bias):
    plan = _plan()
    if plan is None:
        return type(module)._conv_forward(module, x, weight, bias)
    geom = module._spatial_rows
    if geom.local:  # an empty band takes one row of zeros (a conv refuses no rows)
        rows, empty = (F.pad(x, (0, 0, 0, 1)), True) if x.shape[2] == 0 else (x, False)
    else:
        rows, empty = fetch_rows(x, geom, plan)
    y = F.conv2d(rows, weight, bias, module.stride, (0, module.padding[1]), module.dilation,
                 module.groups)
    if empty:
        y = y[:, :, :0]
    if module._spatial_gather:
        y = gather_rows(y, geom.out_height, plan)
    return y


def _pool_rows(module: nn.MaxPool2d, x):
    plan = _plan()
    if plan is None:
        return type(module).forward(module, x)
    rows, empty = fetch_rows(x, module._spatial_rows, plan)
    k, s, p, d = (_pair(v) for v in (module.kernel_size, module.stride, module.padding,
                                     module.dilation))
    y = F.max_pool2d(rows, k, s, (0, p[1]), d, ceil_mode=module.ceil_mode)
    return y[:, :, :0] if empty else y


def _window_rows(module: Reorg, x):
    """A padding-free window layer (the reorg): its own forward on the
    fetched rows."""
    plan = _plan()
    if plan is None:
        return type(module).forward(module, x)
    rows, empty = fetch_rows(x, module._spatial_rows, plan)
    y = type(module).forward(module, rows)
    return y[:, :, :0] if empty else y


def _resize_rows(module: Resize, x, size):
    """This rank's rows of the resize of the whole map to ``size``, whose
    height (taken from a band) must be this rank's band of the output. The
    fetched rows go into a map of the whole height, zero elsewhere (their
    weights for these rows are zero), which is resized whole, then cut: the
    whole map's contractions at the whole map's shapes, so its rows are the
    whole map's bit for bit (a GEMM's summation order may change with its
    shape), for a few MFLOP more a rank."""
    plan = _plan()
    if plan is None:
        return type(module).forward(module, x, size)
    geom = module._spatial_rows
    o0, o1 = plan.rows(geom.out_height)
    if int(size[0]) != o1 - o0:
        raise ValueError(
            f"resize to {tuple(size)} on spatial rank {plan.index}: its band of the "
            f"{geom.out_height}-row output holds {o1 - o0} rows; the target must be a map of "
            f"{geom.out_height} rows split into the same bands")
    if geom.local:
        rows, first = x, o0
    else:
        rows, _ = fetch_rows(x, geom, plan)
        first = _need(geom, (o0, o1))[0]
    whole = F.pad(rows, (0, 0, first, geom.height - first - rows.shape[2]))
    return type(module).forward(module, whole, (geom.out_height, size[1]))[:, :, o0:o1]


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


# the layers whose output rows read a window of input rows
ROW_LAYERS = (nn.Conv2d, nn.MaxPool2d, Resize, Reorg)


def _input_heights(model: nn.Module, image_hw) -> Dict[str, Tuple[int, int]]:
    """Each row layer's (:data:`ROW_LAYERS`) global input and output
    heights, by module name, from one forward of a ``meta`` copy of
    ``model`` (no weight is copied)."""
    memo = {}
    for t in itertools.chain(model.parameters(), model.buffers()):
        meta = torch.empty_like(t, device="meta")
        memo[id(t)] = nn.Parameter(meta, t.requires_grad) if isinstance(t, nn.Parameter) else meta
    twin = copy.deepcopy(model, memo)
    heights: Dict[str, Tuple[int, int]] = {}
    for name, m in twin.named_modules():
        if isinstance(m, ROW_LAYERS):
            m.register_forward_hook(lambda mod, args, y, name=name: heights.__setitem__(
                name, (args[0].shape[2], y.shape[2])))
    twin.eval()
    dtype = next(model.parameters()).dtype
    with torch.no_grad():
        twin(torch.empty((1, 3, int(image_hw[0]), int(image_hw[1])), dtype=dtype, device="meta"),
             phase="train")
    return heights


def predictors(model: nn.Module) -> List[nn.Module]:
    """The predictors whose outputs the loss reads: the model's
    ``predictors`` declaration (YOLO's), else the SSD family's ``loc`` /
    ``conf``."""
    declared = getattr(model, "predictors", None)
    if declared is not None:
        return list(declared)
    if all(isinstance(getattr(model, k, None), nn.ModuleList) for k in ("loc", "conf")):
        return [*model.loc, *model.conf]
    raise NotImplementedError(f"{type(model).__name__}: the spatial axis needs the predictors "
                              "the loss reads (a `predictors` declaration, or loc / conf)")


def partition(model: nn.Module, image_hw) -> int:
    """Give every row layer (:data:`ROW_LAYERS`) of ``model`` its rows'
    geometry at ``image_hw`` and its banded forward, and the last conv of
    each of its :func:`predictors` the head gather; returns how many layers
    fetch rows. Idempotent. Parameter and buffer names do not change."""
    if getattr(model, "_spatial_hw", None) == tuple(image_hw):
        return model._spatial_fetching
    heads = predictors(model)
    heights = _input_heights(model, image_hw)
    fetching = 0
    for name, m in model.named_modules():
        if isinstance(m, ROW_LAYERS) and name in heights:
            fetching += not partition_layer(m, *heights[name]).local
    for pred in heads:
        last = [m for m in pred.modules() if isinstance(m, nn.Conv2d)][-1]
        last._spatial_gather = True
    model._spatial_hw = tuple(image_hw)
    model._spatial_fetching = fetching
    return fetching


def partition_layer(m: nn.Module, height: int, out_height: Optional[int] = None) -> Geometry:
    """Give one row layer (:data:`ROW_LAYERS`) its rows' geometry at the
    global input ``height`` (a resize needs its ``out_height`` too) and its
    banded forward (a conv's ``_conv_forward``, the others' ``forward``);
    returns the geometry."""
    if isinstance(m, Resize):
        m._spatial_rows = WindowGeometry.bilinear(height, out_height)
        m.forward = functools.partial(_resize_rows, m)
        return m._spatial_rows
    if isinstance(m, Reorg):
        m._spatial_rows = RowGeometry(height, m.block, m.block)
        m.forward = functools.partial(_window_rows, m)
        return m._spatial_rows
    k, s, p, d = (_pair(v)[0] for v in (m.kernel_size, m.stride, m.padding, m.dilation))
    if isinstance(m, nn.Conv2d):
        if m.padding_mode != "zeros" or isinstance(m.padding, str):
            raise NotImplementedError(f"{m}: padding {m.padding!r} / {m.padding_mode}")
        m._spatial_rows = RowGeometry(height, k, s, p, d)
        m._spatial_gather = False
        m._conv_forward = functools.partial(_conv_rows, m)
    else:
        m._spatial_rows = RowGeometry(height, k, s, p, d, m.ceil_mode, float("-inf"))
        m.forward = functools.partial(_pool_rows, m)
    return m._spatial_rows


def reduce_gradients(params: Sequence[torch.nn.Parameter], data_size: int) -> None:
    """The step's gradient from every rank's: the sum over the world (each
    rank holds its band's share of its data group's gradient) over the
    ``data_size`` groups, in one all-reduce; a parameter this rank did not
    reach counts zero."""
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.all_reduce(flat)
    flat /= data_size
    at = 0
    for p in params:
        n = p.numel()
        p.grad = flat[at:at + n].view_as(p)
        at += n


__all__ = ["RowGeometry", "Route", "SpatialPlan", "WindowGeometry", "active",
           "check_height", "check_model", "counters", "fetch_rows", "gather_rows", "partition",
           "partition_layer", "predictors", "reduce_gradients", "reset_counters", "route",
           "row_split"]
