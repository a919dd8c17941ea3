"""Rank meshes, weight shards and collectives (counterpart of
``shadowkv_tpu/parallel/mesh.py``).

The JAX package is single-controller: one program over a ``Mesh`` of
devices, GSPMD partitioning plus ``shard_map`` islands. The port runs one
process per rank (``torchrun`` on the card, spawned gloo processes in the
CPU tests), and each rank holds only its own shard of the weights, of the
cache and of the batch; every exchange is an explicit collective below.

Layouts are JAX's, so that "rank r holds block r" means the same in both
packages (ranks of one model replica, ``r`` counted from the replica's
first rank):

- ``build_mesh(dp, tp, sp)``: axes (dp, sp, tp), ``r = (d * sp + s) * tp +
  t`` (JAX reshapes the devices to (dp, sp, tp), or (dp, tp) without sp);
- ``build_mesh_pp(pp, tp, dp)``: axes (pp, dp) or (pp, tp), ``r = p * dp +
  d`` or ``p * tp + t``.

What each rank holds (JAX ``param_pspecs`` / ``shadow_cache_pspecs`` /
``full_cache_pspecs`` / ``*_pp``):

- tp: the Megatron slice of the weights (``shard_params``): wqkv's columns
  ``[q_t | k_t | v_t]`` and w_gate_up's ``[gate_t | up_t]`` (JAX
  ``permute_packed_for_tp`` followed by block ``t``), wo and w_down by input
  rows, lm_head by columns; an int8 ``QTensor``'s scale follows its output
  dim, so the row-sharded wo/w_down keep their whole scale. Of the cache,
  every tensor with a KV-head axis holds heads ``[t K/tp, (t+1) K/tp)``; U
  (shared by the heads) is the same on every tp rank. A rank runs the
  unchanged layer code on a head-scaled ``ModelConfig`` (``local_model``);
  o_proj and the MLP give partial sums that one all-reduce each joins, and
  the lm_head's vocabulary slices meet in one all-gather.
- dp: the batch rows ``[d B/dp, (d+1) B/dp)``; with sp, decode shards the
  batch over (dp, sp) (JAX ``_batch_axes``): decode shard ``d * sp + s``.
- sp: prefill query rows ``[s S/sp, (s+1) S/sp)`` of the dp rows.
- pp: layers ``[p L/pp, (p+1) L/pp)`` of the weights and of every [L, ...]
  cache tensor; the embedding, final norm and lm_head are on every stage.

Collectives. On NCCL every collective runs on the card's stream, so a
decode step that holds them can be captured as one CUDA graph. gloo runs
them on the host: a gloo group on the card (the 2-rank phases of
``chip_smoke.py``, two processes on one card) copies each CUDA tensor to
the host, runs the collective there and copies the result back, so such a
step runs eagerly (``RuntimeConfig.eager_decode``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from shadowkv_tpu_torch.config import ModelConfig
from shadowkv_tpu_torch.core.layers import LayerParams, ModelParams
from shadowkv_tpu_torch.core.wquant import QTensor


def _dist():
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            "a rank mesh needs torch.distributed initialised (torchrun, or "
            "init_process_group with this rank and the world size)")
    return dist


@dataclasses.dataclass
class RankMesh:
    """This rank's place in one model replica: the axis sizes, its
    coordinate on each axis, and one process group per axis (the ranks of
    the replica that differ from this one on that axis only)."""

    dp: int
    tp: int
    sp: int
    pp: int
    coords: dict  # axis -> coordinate
    groups: dict  # axis -> ProcessGroup
    group_ranks: dict  # axis -> global ranks of the group, by coordinate
    batch_group: object  # decode batch shards: dp, or (dp, sp)
    batch_ranks: list  # global ranks of batch_group, by decode shard
    backend: str
    # axis order of the replica's layout (outermost first), the global
    # rank at each position of it, and a gloo group over the replica: host
    # tensors (checkpoints, host V rows) travel on it whatever the backend
    layout: tuple = ()
    replica_ranks: list = dataclasses.field(default_factory=list)
    host_group: object = None

    @property
    def size(self) -> int:
        return self.dp * self.tp * self.sp * self.pp

    @property
    def tp_group(self):
        return self.groups["tp"]

    @property
    def batch_shards(self) -> int:
        """Decode batch shards: dp * sp (sp ranks decode as extra dp)."""
        return self.dp * self.sp

    @property
    def batch_index(self) -> int:
        return self.coords["dp"] * self.sp + self.coords["sp"]

    def batch_rows(self, batch: int) -> slice:
        """This rank's rows of a decode batch of ``batch`` sequences."""
        n = self.batch_shards
        if batch % n:
            raise ValueError(f"batch {batch} must divide into the {n} "
                             "decode batch shards (dp * sp)")
        b = batch // n
        return slice(self.batch_index * b, (self.batch_index + 1) * b)

    def prefill_rows(self, batch: int) -> slice:
        """This rank's rows of a prefill batch (dp shards)."""
        if batch % self.dp:
            raise ValueError(f"batch {batch} must divide over dp={self.dp}")
        b = batch // self.dp
        d = self.coords["dp"]
        return slice(d * b, (d + 1) * b)

    def head_slice(self, heads: int) -> slice:
        n = heads // self.tp
        t = self.coords["tp"]
        return slice(t * n, (t + 1) * n)

    def layer_slice(self, layers: int) -> slice:
        n = layers // self.pp
        p = self.coords["pp"]
        return slice(p * n, (p + 1) * n)

    def owner_of_row(self, row: int, batch: int) -> int:
        """The global rank of ``batch_group`` that holds decode row
        ``row``."""
        return self.batch_ranks[row // (batch // self.batch_shards)]

    @property
    def rank(self) -> int:
        """This process's global rank."""
        return self.batch_ranks[self.batch_index]

    def rank_of(self, **coords) -> int:
        """The global rank of this replica at ``coords`` (axes left out are
        at 0)."""
        i = 0
        for a in self.layout:
            i = i * getattr(self, a) + coords.get(a, 0)
        return self.replica_ranks[i]

    def batch_coords(self, shard: int) -> dict:
        """The (dp, sp) coordinates of decode batch shard ``shard``."""
        return {"dp": shard // self.sp, "sp": shard % self.sp}


def _build(axes: dict, order: tuple) -> RankMesh:
    """A mesh of the axis sizes ``axes`` laid out in ``order`` (outermost
    first) over each replica of ``n = prod(axes)`` consecutive ranks, its
    groups on the world's backend. Every process creates every group, in
    one order, as ``new_group`` asks."""
    dist = _dist()
    world, me = dist.get_world_size(), dist.get_rank()
    n = 1
    for a in order:
        n *= axes[a]
    if world % n:
        raise ValueError(f"world size {world} is not a multiple of the "
                         f"mesh's {n} ranks")
    sizes = [axes[a] for a in order]

    def coords_of(r: int) -> dict:
        out = {}
        for a, sz in zip(reversed(order), reversed(sizes)):
            out[a] = r % sz
            r //= sz
        return out

    def index(c: dict, varying: tuple) -> int:
        """The position within its group of the rank at ``c``."""
        i = 0
        for a, sz in zip(order, sizes):
            if a in varying:
                i = i * sz + c[a]
        return i

    mine = coords_of(me % n)
    groups, group_ranks = {}, {}
    host_group = replica = None
    # one group per axis, and the decode batch shards (dp, sp) in one
    kinds = [(a, (a,)) for a in order] + [("batch", ("dp", "sp"))]
    for base in range(0, world, n):
        for name, varying in kinds:
            members: dict = {}
            for r in range(n):
                c = coords_of(r)
                key = tuple(v for a, v in c.items() if a not in varying)
                members.setdefault(key, []).append((index(c, varying),
                                                    base + r))
            for ranks in members.values():
                ranks = [g for _, g in sorted(ranks)]
                group = dist.new_group(ranks)
                if me in ranks:
                    groups[name], group_ranks[name] = group, ranks
        ranks = list(range(base, base + n))
        group = dist.new_group(ranks, backend="gloo")
        if me in ranks:
            host_group, replica = group, ranks
    batch_group, batch_ranks = groups.pop("batch"), group_ranks.pop("batch")
    full = {"dp": 1, "tp": 1, "sp": 1, "pp": 1}
    full.update(axes)
    coords = {a: mine.get(a, 0) for a in full}
    for a in full:
        if a not in groups:  # an axis this layout lacks
            groups[a], group_ranks[a] = None, [me]
    return RankMesh(
        dp=full["dp"], tp=full["tp"], sp=full["sp"], pp=full["pp"],
        coords=coords, groups=groups, group_ranks=group_ranks,
        batch_group=batch_group, batch_ranks=batch_ranks,
        backend=dist.get_backend(), layout=order, replica_ranks=replica,
        host_group=host_group,
    )


def build_mesh(dp: int, tp: int, sp: int = 1) -> RankMesh:
    """The (dp, sp, tp) mesh (JAX ``build_mesh``, ``mesh.py:28``): rank
    ``(d * sp + s) * tp + t`` of each replica."""
    return _build({"dp": dp, "sp": sp, "tp": tp}, ("dp", "sp", "tp"))


def build_mesh_pp(pp: int, tp: int = 1, dp: int = 1) -> RankMesh:
    """The (pp, dp) or (pp, tp) mesh (JAX ``build_mesh_pp``, ``:44``): rank
    ``p * dp + d`` or ``p * tp + t``; pp composes with dp or with tp, not
    with both."""
    if tp > 1 and dp > 1:
        raise ValueError("pp composes with EITHER dp OR tp")
    second = "tp" if tp > 1 else "dp"
    return _build({"pp": pp, second: max(tp, dp)}, ("pp", second))


def local_model(model: ModelConfig, mesh: RankMesh) -> ModelConfig:
    """The head-, ffn- and layer-scaled config of one rank's shard (JAX's
    pp x tp pipeline runs its body on such a config)."""
    return dataclasses.replace(
        model,
        num_layers=model.num_layers // mesh.pp,
        num_heads=model.num_heads // mesh.tp,
        num_kv_heads=model.num_kv_heads // mesh.tp,
        intermediate_size=model.intermediate_size // mesh.tp,
    )


def check_divisible(model: ModelConfig, tp: int, pp: int) -> None:
    """The shapes a rank's shard needs (ValueError otherwise)."""
    if model.num_kv_heads % tp:
        raise ValueError(f"tp={tp} must divide num_kv_heads "
                         f"{model.num_kv_heads}")
    if model.intermediate_size % tp or model.vocab_size % tp:
        raise ValueError(
            f"tp={tp} must divide intermediate_size "
            f"{model.intermediate_size} and vocab_size {model.vocab_size}")
    if model.num_layers % pp:
        raise ValueError(f"pp={pp} must divide num_layers "
                         f"{model.num_layers}")


# ---------------------------------------------------------------------------
# Weight shards
# ---------------------------------------------------------------------------


def _take_cols(leaf, idx: torch.Tensor):
    """Columns ``idx`` of a weight's output (last) dim, QTensor-aware."""
    if leaf is None:
        return None
    if isinstance(leaf, QTensor):
        return QTensor(q=leaf.q.index_select(-1, idx.to(leaf.q.device)),
                       s=leaf.s.index_select(-1, idx.to(leaf.s.device)))
    return leaf.index_select(-1, idx.to(leaf.device))


def _rows(leaf, sl: slice):
    """Input rows ``sl`` (dim -2) of a stacked weight; a QTensor keeps its
    whole per-output scale (JAX ``_wspec`` drops the contracted dim)."""
    if isinstance(leaf, QTensor):
        return QTensor(q=leaf.q[..., sl, :].contiguous(), s=leaf.s.clone())
    return leaf[..., sl, :].contiguous()


def _layers(leaf, sl: slice):
    if leaf is None:
        return None
    if isinstance(leaf, QTensor):
        return QTensor(q=leaf.q[sl], s=leaf.s[sl])
    return leaf[sl]


def packed_columns(model: ModelConfig, tp: int, t: int):
    """Rank ``t``'s columns of the packed wqkv ``[q | k | v]`` and w_gate_up
    ``[gate | up]``: block ``t`` of JAX ``permute_packed_for_tp``'s
    permutation."""
    h, kh, dh = model.num_heads, model.num_kv_heads, model.head_dim
    i = model.intermediate_size
    hl, kl, il = h // tp, kh // tp, i // tp

    def cols(*sections):
        return torch.cat([off + t * w + torch.arange(w)
                          for off, w in sections])

    qkv = cols((0, hl * dh), (h * dh, kl * dh), ((h + kh) * dh, kl * dh))
    gu = cols((0, il), (i, il))
    return qkv, gu


def shard_params(params: ModelParams, model: ModelConfig,
                 mesh: RankMesh) -> ModelParams:
    """This rank's shard of the whole model's ``params`` (JAX
    ``param_pspecs`` / ``param_pspecs_pp`` after ``permute_packed_for_tp``):
    its layers under pp, its Megatron slice under tp. New tensors: the
    caller may free the whole model's afterwards (a mesh with neither tp
    nor pp has nothing to slice and returns ``params`` itself)."""
    check_divisible(model, mesh.tp, mesh.pp)
    if mesh.tp == 1 and mesh.pp == 1:
        return params
    lay = params.layers
    lsl = mesh.layer_slice(model.num_layers)
    lay = LayerParams(*(_layers(x, lsl) for x in lay))
    lm_head = params.lm_head
    if mesh.tp > 1:
        t = mesh.coords["tp"]
        qkv, gu = packed_columns(model, mesh.tp, t)
        qs = mesh.head_slice(model.num_heads)
        rows_o = slice(qs.start * model.head_dim, qs.stop * model.head_dim)
        isz = model.intermediate_size // mesh.tp
        lay = lay._replace(
            wqkv=_take_cols(lay.wqkv, qkv),
            bqkv=_take_cols(lay.bqkv, qkv),
            wo=_rows(lay.wo, rows_o),
            w_gate_up=_take_cols(lay.w_gate_up, gu),
            w_down=_rows(lay.w_down, slice(t * isz, (t + 1) * isz)),
        )
        vl = model.vocab_size // mesh.tp
        lm_head = _take_cols(lm_head, torch.arange(t * vl, (t + 1) * vl))

    def own(x):
        if x is None:
            return None
        if isinstance(x, QTensor):
            return QTensor(q=x.q.contiguous().clone(), s=x.s.contiguous().clone())
        return x.contiguous().clone()

    return ModelParams(
        embed=params.embed,
        layers=LayerParams(*(own(x) for x in lay)),
        final_norm=params.final_norm,
        lm_head=own(lm_head),
    )


def shard_jax_params(np_tree, model: ModelConfig, mesh: RankMesh,
                     device=None) -> ModelParams:
    """This rank's shard of JAX's numpy params (the ``from_jax_params``
    input)."""
    from shadowkv_tpu_torch.models.params import from_jax_params

    return shard_params(from_jax_params(np_tree, device), model, mesh)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _staged(x: torch.Tensor, group) -> bool:
    """A CUDA tensor on a gloo group goes through the host."""
    return x.is_cuda and _dist().get_backend(group) == "gloo"


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, in place; returns ``x``."""
    dist = _dist()
    if _staged(x, group):
        h = x.cpu()
        dist.all_reduce(h, group=group)
        x.copy_(h)
    else:
        dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``x`` of every rank of ``group``, concatenated along ``dim`` in the
    group's rank order."""
    dist = _dist()
    n = dist.get_world_size(group)
    src = x.contiguous()
    if _staged(x, group) or dist.get_backend(group) == "gloo":
        h = src.cpu()
        parts = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(parts, h, group=group)
        out = torch.cat(parts, dim=dim)
        return out.to(x.device) if x.is_cuda else out
    out = torch.empty((n * src.shape[0],) + src.shape[1:], dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    if dim == 0:
        return out
    parts = out.view((n,) + src.shape)
    return torch.cat(parts.unbind(0), dim=dim)


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of global rank ``src`` on every rank of ``group``, in place."""
    dist = _dist()
    if _staged(x, group):
        h = x.cpu()
        dist.broadcast(h, src=src, group=group)
        x.copy_(h)
    else:
        dist.broadcast(x, src=src, group=group)
    return x


def exchange(send: Optional[torch.Tensor], dst: Optional[int],
             recv: Optional[torch.Tensor], src: Optional[int],
             group) -> None:
    """One pipeline hop (``batch_isend_irecv``): send ``send`` to global
    rank ``dst`` and receive into ``recv`` from ``src``, either may be None.
    gloo sends host tensors only, so CUDA tensors go through the host."""
    dist = _dist()
    gloo = dist.get_backend(group) == "gloo"
    s = send.cpu() if (send is not None and gloo) else send
    r = recv.new_empty(recv.shape, device="cpu") \
        if (recv is not None and gloo and recv.is_cuda) else recv
    ops = []
    if s is not None:
        ops.append(dist.P2POp(dist.isend, s.contiguous(), dst, group=group))
    if r is not None:
        ops.append(dist.P2POp(dist.irecv, r, src, group=group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    if r is not None and r is not recv:
        recv.copy_(r)
