"""Prefilled-state checkpoints: a ShadowCache on disk (counterpart of
``shadowkv_tpu/utils/checkpoint.py``).

A context that took seconds to prefill (low-rank factors, landmarks, int8
stores) resumes in the time it takes to read one file, in this process or
another: ``Engine.save_state`` / ``load_state``, then
``generate(cont=True)``.

Format: one uncompressed ``.npz`` holding every array field of the port's
``ShadowCache`` (``ShadowCache.FIELDS``; bfloat16 stored as an int16 view,
numpy having no bfloat16), ``gen_len`` (0-d, or [B] per-slot depths), and a
``__meta__`` JSON header: the ``ShadowLayout``, each entry's dtype, the
format version, whether the V store was in host memory and the writing
engine's V placement (``variant``). The port lays
its stores out in its own way (ROADMAP.md "Layouts"), so the format has its
own version and does not read the JAX package's files.

A file is always the whole cache at its global shape, whatever wrote it
(JAX's contract: ``save_state`` reads the sharded cache as one array,
``load_state`` reshards it onto the loading engine's mesh). On a rank mesh
(``parallel/mesh.py``) the replica's first rank writes it: every other rank
sends it its slices over the replica's gloo group, one layer of one field
at a time, and the writer streams each layer into its ``.npy`` entry, so
its host memory holds one layer, not the file. Each rank's slice of a
field ``[L, B, ...]``: its stage's layers (pp, dim 0), its decode batch
shard's rows (dp, and sp after its prefill; dim 1, ``gen_len`` [B] too)
and its KV heads (tp, dim 2 of ``HEAD_FIELDS``); U and its scale have no
head axis and are the same on every tp rank, so tp rank 0's copy is
written. Loading reads the header and the entries' shapes first, then
each rank maps the file and copies out its own slice, layer by layer.

The V store loads wherever the loading engine keeps it: on the device, or
straight into a host tensor (pinned when the engine runs on the card) that
it never leaves, so a file written with V on the card loads into a
``shadow_offload`` engine without passing through device memory, and the
reverse. A host V store is also saved through host memory only.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import zipfile
from typing import Callable, Optional

import numpy as np
import torch

from shadowkv_tpu_torch.cache.shadow import ShadowCache, ShadowLayout

FORMAT_VERSION = 1
_ENTRIES = ShadowCache.FIELDS + ("gen_len",)
# fields with a KV-head axis (dim 2), which tp shards
HEAD_FIELDS = ("sv", "landmarks", "landmark_mask", "k_buf", "v_buf",
               "v_full", "cached_ids", "lm_scale", "v_scale")
# The writer receives every tp rank's copy of U and its scale and checks
# that they agree (the mesh tests set it); otherwise only tp rank 0 sends.
VERIFY_SHARED = False


def _decode(a: np.ndarray, name: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the file stores it (bfloat16 as int16), on the host."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().contiguous()


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------


class _Senders:
    """Who holds what of the cache on a mesh: for each layer (and for
    ``gen_len``) the global ranks whose slices make the global block, in
    block order, with each one's (batch shard, tp rank)."""

    def __init__(self, mesh, layers_local: int):
        self.mesh = mesh
        self.per_stage = layers_local

    def of_layer(self, layer: int, heads: bool) -> list:
        m = self.mesh
        p = layer // self.per_stage
        tps = range(m.tp) if (heads or VERIFY_SHARED) else range(1)
        return [(m.rank_of(pp=p, tp=t, **m.batch_coords(b)), b, t)
                for b in range(m.batch_shards) for t in tps]

    def of_gen_len(self) -> list:
        m = self.mesh
        return [(m.rank_of(**m.batch_coords(b)), b, 0)
                for b in range(m.batch_shards)]


def _write_entry(zf: zipfile.ZipFile, name: str, shape: tuple, dtype,
                 blocks) -> None:
    """One ``.npy`` entry of ``shape`` streamed from ``blocks``, numpy
    arrays whose bytes follow each other in C order (np.savez's layout:
    stored, zip64)."""
    header = {"descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
              "fortran_order": False, "shape": tuple(shape)}
    with zf.open(name + ".npy", "w", force_zip64=True) as fh:
        np.lib.format.write_array_header_1_0(fh, header)
        for block in blocks:
            fh.write(np.ascontiguousarray(block).data)


def save_shadow_state(cache: ShadowCache, path: str, variant: str = "hbm",
                      mesh=None) -> None:
    """Write a prefilled (or mid-generation) ShadowCache to ``path``.
    ``variant`` records which V placement wrote it (as JAX's header does:
    'hbm', 'host' for the kernels' pinned store, 'io_callback' for the
    HostVStore path); any variant loads into any other. On a rank ``mesh``
    every rank of the replica calls this with its own shard; the
    replica's first rank writes the whole cache, and every rank returns
    once the file is complete."""
    if mesh is None:
        _write(cache, path, variant, None, None)
        return
    import torch.distributed as dist

    group = mesh.host_group
    writer = mesh.rank_of()
    senders = _Senders(mesh, cache.k_buf.shape[0])
    try:
        mismatch = _write(cache, path, variant, mesh, senders) \
            if mesh.rank == writer else _send(cache, mesh, senders, writer)
    finally:
        dist.barrier(group=group)
    if mismatch:
        raise AssertionError(f"the tp ranks' copies of {mismatch} differ")


def _send(cache: ShadowCache, mesh, senders: _Senders, writer: int):
    """A non-writing rank's part of a mesh save: its slices, in the
    writer's order."""
    import torch.distributed as dist

    me, group = mesh.rank, mesh.host_group
    l0 = mesh.layer_slice(senders.per_stage * mesh.pp).start
    for name in ShadowCache.FIELDS:
        val = getattr(cache, name)
        if val is None:
            continue
        for layer in range(l0, l0 + val.shape[0]):
            if any(r == me for r, _, _ in senders.of_layer(
                    layer, name in HEAD_FIELDS)):
                dist.send(_wire(val[layer - l0]), writer, group=group)
    if cache.gen_len.dim() and any(
            r == me for r, _, _ in senders.of_gen_len()):
        dist.send(_wire(cache.gen_len), writer, group=group)
    return None


def _write(cache: ShadowCache, path: str, variant: str, mesh,
           senders: Optional[_Senders]):
    """The writer's part: every entry at its global shape, one layer of it
    in memory at a time. Returns the shared fields whose tp copies differ
    (``VERIFY_SHARED``)."""
    import torch.distributed as dist

    tp = mesh.tp if mesh is not None else 1
    shards = mesh.batch_shards if mesh is not None else 1
    pp = mesh.pp if mesh is not None else 1
    mismatch = []

    def gathered(name, local, heads, who):
        """The global block whose local part is ``local`` (host, wire
        dtype; batch at dim 0, heads at dim 1) from the ranks ``who``."""
        if mesh is None:
            return local.numpy()
        b = local.shape[0]
        shape = list(local.shape)
        shape[0] *= shards
        if heads:
            shape[1] *= tp
        out = torch.empty(shape, dtype=local.dtype)
        for rank, shard, t in who:
            part = local if rank == mesh.rank else torch.empty_like(local)
            if rank != mesh.rank:
                dist.recv(part, rank, group=mesh.host_group)
            rows = slice(shard * b, (shard + 1) * b)
            if heads:
                k = local.shape[1]
                out[rows, t * k:(t + 1) * k] = part
            elif t == 0:
                out[rows] = part
            elif not torch.equal(out[rows], part) and name not in mismatch:
                mismatch.append(name)
        return out.numpy()

    dtypes: dict[str, str] = {}
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name in ShadowCache.FIELDS:
            val = getattr(cache, name)
            if val is None:
                continue
            dtypes[name] = str(val.dtype).removeprefix("torch.")
            heads = name in HEAD_FIELDS
            wire = _wire(val.new_empty((0,) + tuple(val.shape[1:]),
                                       device="cpu"))
            shape = [val.shape[0] * pp, val.shape[1] * shards,
                     *val.shape[2:]]
            if heads:
                shape[2] *= tp

            def block(layer, val=val, wire=wire, heads=heads, name=name):
                # the writer is stage 0: layers [0, L/pp) are its own
                mine = layer < val.shape[0]
                local = _wire(val[layer]) if mine else torch.empty(
                    wire.shape[1:], dtype=wire.dtype)
                if mesh is None:
                    return local.numpy()
                return gathered(name, local, heads,
                                senders.of_layer(layer, heads))

            _write_entry(zf, name, shape, wire.numpy().dtype,
                         (block(layer) for layer in range(shape[0])))
        dtypes["gen_len"] = str(cache.gen_len.dtype).removeprefix("torch.")
        g = _wire(cache.gen_len)
        if g.dim() and mesh is not None:
            g = torch.from_numpy(gathered("gen_len", g[:, None], False,
                                          senders.of_gen_len()))[:, 0]
        _write_entry(zf, "gen_len", tuple(g.shape), g.numpy().dtype,
                     [g.numpy()])
        meta = {
            "version": FORMAT_VERSION,
            "layout": dataclasses.asdict(cache.layout),
            "dtypes": dtypes,
            "v_on_host": cache.v_on_host,
            "variant": variant,
        }
        raw = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        _write_entry(zf, "__meta__", raw.shape, raw.dtype, [raw])
    return mismatch


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Entry:
    offset: int  # the array's first byte in the file
    shape: tuple
    dtype: np.dtype


def _index(path: str) -> dict[str, _Entry]:
    """Where each ``.npy`` entry's array lies in the (stored) npz file."""
    readers = {(1, 0): np.lib.format.read_array_header_1_0,
               (2, 0): np.lib.format.read_array_header_2_0}
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as fh:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"checkpoint entry {info.filename} is "
                                 "compressed; the format stores entries")
            fh.seek(info.header_offset)
            local = fh.read(30)
            n, m = struct.unpack("<HH", local[26:30])
            fh.seek(info.header_offset + 30 + n + m)
            version = np.lib.format.read_magic(fh)
            shape, fortran, dtype = readers[version](fh)
            if fortran:
                raise ValueError(f"checkpoint entry {info.filename} is in "
                                 "Fortran order")
            out[info.filename.removesuffix(".npy")] = _Entry(fh.tell(), shape,
                                                             dtype)
    return out


def _read(path: str, e: _Entry) -> np.ndarray:
    """A read-only map of entry ``e`` (small ones read outright)."""
    count = int(np.prod(e.shape, dtype=np.int64))
    if count * e.dtype.itemsize < 1 << 16:
        with open(path, "rb") as fh:
            fh.seek(e.offset)
            raw = fh.read(count * e.dtype.itemsize)
        return np.frombuffer(raw, dtype=e.dtype).reshape(e.shape)
    return np.memmap(path, dtype=e.dtype, mode="r", offset=e.offset,
                     shape=e.shape)


def _header(path: str) -> tuple[dict, dict[str, _Entry]]:
    """The ``__meta__`` header and the index of the entries; no array is
    read."""
    index = _index(path)
    meta = json.loads(bytes(_read(path, index.pop("__meta__"))).decode())
    if meta.get("version") != FORMAT_VERSION:
        raise ValueError(f"checkpoint format {meta.get('version')} is "
                         f"not this package's {FORMAT_VERSION}")
    return meta, index


def load_shadow_state(
    path: str, device, v_on_host: bool = False,
    check: Optional[Callable[[ShadowLayout], None]] = None,
    mesh=None,
    check_shapes: Optional[Callable[[dict], None]] = None,
) -> ShadowCache:
    """Read a checkpoint into a ShadowCache on ``device``; with
    ``v_on_host`` the V store goes into a host tensor (pinned when
    ``device`` is a CUDA device) instead. ``check`` sees the layout and
    ``check_shapes`` every entry's global shape before any array is read.
    On a rank ``mesh`` the cache is this rank's slice (see the module
    note)."""
    device = torch.device(device)
    meta, index = _header(path)
    layout = ShadowLayout(**meta["layout"])
    if check is not None:
        check(layout)
    if check_shapes is not None:
        check_shapes({k: e.shape for k, e in index.items()})
    fields = {}
    for name in _ENTRIES:
        if name not in index:
            fields[name] = None
            continue
        e = index[name]
        arr = _read(path, e)
        dtype = meta["dtypes"][name]
        if name == "gen_len":
            if arr.ndim and mesh is not None:
                arr = arr[mesh.batch_rows(arr.shape[0])]
            fields[name] = _decode(np.array(arr), dtype).to(device)
            continue
        lsl, rows, heads = slice(None), slice(None), slice(None)
        if mesh is not None:
            lsl = mesh.layer_slice(e.shape[0])
            rows = mesh.batch_rows(e.shape[1])
            if name in HEAD_FIELDS:
                heads = mesh.head_slice(e.shape[2])
        layers = range(e.shape[0])[lsl]
        shape = (len(layers),) + arr[0, rows, heads].shape
        tdtype = _decode(np.empty(0, e.dtype), dtype).dtype
        if name == "v_full" and v_on_host:
            out = torch.empty(shape, dtype=tdtype,
                              pin_memory=device.type == "cuda")
        else:
            out = torch.empty(shape, dtype=tdtype, device=device)
        for i, layer in enumerate(layers):
            out[i].copy_(_decode(np.array(arr[layer, rows, heads]), dtype))
        fields[name] = out
        del arr
    return ShadowCache(layout=layout, v_on_host=v_on_host, **fields)
