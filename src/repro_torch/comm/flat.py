"""Flat wire-buffer layout: the canonical in-round representation of
every piece of client-visible state (params, Sophia m/h).

Every leaf of the parameter dict is flattened to fp32, concatenated,
zero-padded and reshaped to a ``(rows, cols)`` buffer.  Leaves go in
**sorted-key order**, the order `jax.tree_util.tree_flatten` gives a
dict, so a buffer packed here holds the same coordinates at the same
offsets as the JAX package's (`MLPTask`: ``b1,b2,b3,w1,w2,w3``).

Buffers may carry leading (per-client) axes: `pack` / `unpack` /
`repack` treat every axis in front of a leaf's own shape as a lead
axis, so one spec serves the ``(rows, cols)`` server model and the
``(C, rows, cols)`` client stacks.

The three wire streams share the flattened coordinate order but may
disagree on ``cols`` (each stream's own ``quant_block``); `repack`
moves a buffer between two geometries.

This module also owns the versioned 24-byte wire `Header` every
serialized payload carries (the layout of the JAX package's
``docs/wire-format.md``), and `check_headers`, which refuses to restore
comm state written under another layout.
"""
from __future__ import annotations

import dataclasses
import struct
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import store_as, store_into

#: magic + version of the serialized wire-buffer format.  Version 2
#: carries the resident-state dtype in the flags byte; version-1
#: headers (flags = 0) still decode, as float32.
WIRE_MAGIC = b"FSWB"
WIRE_VERSION = 2
SUPPORTED_WIRE_VERSIONS = (1, 2)
#: <magic 4s><version u16><compressor u8><flags u8><total u64>
#: <quant_block u32><aux u32>, little-endian.  flags (v2): low 4 bits =
#: state-dtype id, high 4 bits reserved.
_HEADER_STRUCT = struct.Struct("<4sHBBQII")
HEADER_BYTES = _HEADER_STRUCT.size          # 24

#: stable on-the-wire ids (append only)
COMPRESSOR_IDS = {"identity": 0, "int8": 1, "int4": 2, "topk": 3,
                  "signsgd": 4}
_ID_COMPRESSORS = {v: k for k, v in COMPRESSOR_IDS.items()}
STATE_DTYPE_IDS = {"float32": 0, "bfloat16": 1,
                   "float8_e4m3fn": 2, "float8_e5m2": 3}
_ID_STATE_DTYPES = {v: k for k, v in STATE_DTYPE_IDS.items()}

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float8_e4m3fn": torch.float8_e4m3fn,
                 "float8_e5m2": torch.float8_e5m2}
assert set(_STATE_DTYPES) == set(STATE_DTYPE_IDS)


def as_dtype(state_dtype: str) -> torch.dtype:
    """`CommConfig.state_dtype` name -> torch dtype."""
    try:
        return _STATE_DTYPES[state_dtype]
    except KeyError:
        raise ValueError(
            f"unknown state_dtype {state_dtype!r} "
            f"(want one of {tuple(_STATE_DTYPES)})") from None


@dataclass(frozen=True)
class Header:
    """The versioned 24-byte preamble of every serialized payload, and
    the checkpoint fingerprint of wire-layout engine state.

    ``aux`` carries the compressor's layout parameter (top-k: ``k``), 0
    otherwise.  ``state_dtype`` (v2) is the storage dtype of resident
    state written under this header; v1 headers decode as float32."""
    compressor: str
    total: int
    quant_block: int
    aux: int = 0
    version: int = WIRE_VERSION
    state_dtype: str = "float32"

    def pack(self) -> bytes:
        if self.compressor not in COMPRESSOR_IDS:
            raise ValueError(f"unknown compressor {self.compressor!r}")
        if self.state_dtype not in STATE_DTYPE_IDS:
            raise ValueError(f"unknown state_dtype {self.state_dtype!r}")
        flags = STATE_DTYPE_IDS[self.state_dtype]
        if self.version == 1 and flags:
            raise ValueError(
                "wire-format v1 cannot carry a non-float32 state_dtype "
                "(the flags byte was reserved = 0); write v2")
        return _HEADER_STRUCT.pack(
            WIRE_MAGIC, self.version, COMPRESSOR_IDS[self.compressor],
            flags, self.total, self.quant_block, self.aux)

    @classmethod
    def unpack(cls, buf: bytes) -> "Header":
        if len(buf) < HEADER_BYTES:
            raise ValueError(
                f"wire buffer too short for a header: {len(buf)} < "
                f"{HEADER_BYTES} bytes")
        magic, ver, comp_id, flags, total, qb, aux = \
            _HEADER_STRUCT.unpack_from(buf)
        if magic != WIRE_MAGIC:
            raise ValueError(f"not a Fed-Sophia wire buffer (magic "
                             f"{magic!r}, expected {WIRE_MAGIC!r})")
        if ver not in SUPPORTED_WIRE_VERSIONS:
            raise ValueError(
                f"unsupported wire-format version {ver} (this build "
                f"speaks versions {SUPPORTED_WIRE_VERSIONS})")
        if comp_id not in _ID_COMPRESSORS:
            raise ValueError(f"unknown wire compressor id {comp_id}")
        if ver == 1:
            if flags:
                raise ValueError(f"wire-format v1 header with nonzero "
                                 f"reserved flags byte ({flags:#x})")
            sdt = "float32"
        else:
            if flags & 0xF0:
                raise ValueError(f"wire-format v2 header with nonzero "
                                 f"reserved flag bits ({flags:#x})")
            if flags & 0x0F not in _ID_STATE_DTYPES:
                raise ValueError(f"unknown wire state-dtype id "
                                 f"{flags & 0x0F}")
            sdt = _ID_STATE_DTYPES[flags & 0x0F]
        return cls(compressor=_ID_COMPRESSORS[comp_id], total=total,
                   quant_block=qb, aux=aux, version=ver, state_dtype=sdt)

    def to_dict(self) -> Dict[str, Any]:
        return {"version": self.version, "compressor": self.compressor,
                "total": self.total, "quant_block": self.quant_block,
                "aux": self.aux, "state_dtype": self.state_dtype}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Header":
        # v1 manifests predate the state_dtype field: default float32
        return cls(compressor=d["compressor"], total=int(d["total"]),
                   quant_block=int(d["quant_block"]),
                   aux=int(d.get("aux", 0)),
                   version=int(d.get("version", 1)),
                   state_dtype=d.get("state_dtype", "float32"))


def check_headers(saved: Dict[str, Dict[str, Any]],
                  current: Dict[str, Dict[str, Any]]) -> None:
    """Validate checkpointed per-stream wire headers against the current
    engine's (`FedEngine.wire_headers`).  Raises ValueError naming every
    mismatched stream and field.  Only the layout fields (compressor,
    total, quant_block, aux) must match; ``state_dtype`` is a runtime
    choice and is not compared, and any supported version loads."""
    if not saved:
        raise ValueError(
            "the checkpoint manifest carries no wire headers: cannot "
            "prove the comm/EF layouts match; re-save the checkpoint "
            "with this build")
    problems = []
    for stream in sorted(set(saved) | set(current)):
        if stream not in saved:
            problems.append(f"stream {stream!r}: active now but the "
                            "checkpoint has no wire header for it")
            continue
        if stream not in current:
            problems.append(f"stream {stream!r}: present in the "
                            "checkpoint but not active now")
            continue
        s, c = saved[stream], current[stream]
        for d, when in ((s, "save time"), (c, "now")):
            ver = int(d.get("version", 1))
            if ver not in SUPPORTED_WIRE_VERSIONS:
                problems.append(
                    f"stream {stream!r}: wire-format version {ver} "
                    f"({when}) is not supported by this build "
                    f"({SUPPORTED_WIRE_VERSIONS})")
        for field_ in ("compressor", "total", "quant_block", "aux"):
            if s.get(field_) != c.get(field_):
                problems.append(
                    f"stream {stream!r}: {field_} was {s.get(field_)!r} "
                    f"at save time but is {c.get(field_)!r} now")
    if problems:
        raise ValueError(
            "wire-layout mismatch between checkpoint and current comm "
            "config:\n  " + "\n  ".join(problems))


@dataclass(frozen=True)
class FlatSpec:
    """Static description of the packed layout."""
    keys: Tuple[str, ...]
    sizes: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    total: int                 # true element count (pre-padding)
    rows: int
    cols: int

    @property
    def padded(self) -> int:
        return self.rows * self.cols


def _check_tree(tree) -> None:
    if not isinstance(tree, dict) or not all(
            isinstance(v, torch.Tensor) for v in tree.values()):
        raise TypeError("the port packs flat dict[str, Tensor] parameter "
                        f"trees, got {type(tree).__name__}")


def flat_spec(tree: Dict[str, torch.Tensor], cols: int = 1024) -> FlatSpec:
    """Build the layout spec from an unbatched parameter dict."""
    _check_tree(tree)
    keys = tuple(sorted(tree))
    shapes = tuple(tuple(tree[k].shape) for k in keys)
    sizes = tuple(int(tree[k].numel()) for k in keys)
    dtypes = tuple(tree[k].dtype for k in keys)
    total = sum(sizes)
    rows = -(-total // cols)
    return FlatSpec(keys, sizes, shapes, dtypes, total, rows, cols)


def with_cols(spec: FlatSpec, cols: int) -> FlatSpec:
    """The same coordinates packed ``cols`` to a row (another stream's
    geometry)."""
    return dataclasses.replace(spec, cols=cols, rows=-(-spec.total // cols))


def leaf_coords(spec: FlatSpec, suffix: str, lo: int,
                hi: int) -> torch.Tensor:
    """The flat coordinates, in ``spec``'s packed layout, of
    ``leaf[..., lo:hi]`` for every leaf whose key ends with ``suffix``
    (int64, ascending)."""
    parts, start = [], 0
    for k, size, shape in zip(spec.keys, spec.sizes, spec.shapes):
        if k.endswith(suffix):
            idx = torch.arange(start, start + size).reshape(shape)
            parts.append(idx[..., lo:hi].reshape(-1))
        start += size
    return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64)


def zeros(spec: FlatSpec, lead: Tuple[int, ...] = (),
          dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """A zeroed flat state buffer in ``spec``'s layout, with optional
    leading (per-client) axes, stored as ``dtype`` (+0 is all-zero bits
    in every state dtype)."""
    shape = tuple(lead) + (spec.rows, spec.cols)
    if dtype.itemsize == 1:
        return torch.zeros(shape, dtype=torch.uint8,
                           device=device).view(dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, or for a one-byte float a ``uint8`` view of its
    bits: torch implements no row gather, scatter or concatenation of
    the fp8 dtypes on every device, and these moves are bit copies."""
    return x.view(torch.uint8) if x.element_size() == 1 else x


def take_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``x.index_select(0, ids)`` in any state dtype (a copy)."""
    return _bits(x).index_select(0, ids).view(x.dtype)


def put_rows_(full: torch.Tensor, ids: torch.Tensor,
              rows: torch.Tensor) -> torch.Tensor:
    """``full.index_copy_(0, ids, rows)`` in any state dtype, ``rows``
    stored in ``full``'s dtype first (`store_as`).  Returns ``full``."""
    rows = store_as(rows, full.dtype)
    _bits(full).index_copy_(0, ids, _bits(rows))
    return full


def cat_rows(parts) -> torch.Tensor:
    """``torch.cat`` of same-dtype buffers in any state dtype."""
    return torch.cat([_bits(p) for p in parts]).view(parts[0].dtype)


def pack(tree: Dict[str, torch.Tensor], spec: FlatSpec,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Parameter dict -> ``(*lead, rows, cols)`` wire buffer (zero pad at
    the tail), stored as ``dtype``."""
    _check_tree(tree)
    first = tree[spec.keys[0]]
    lead = tuple(first.shape[:first.ndim - len(spec.shapes[0])])
    # each leaf cast straight into its place in one fp32 buffer: no
    # upcast copies, no concatenation, no padded copy (an LM's buffers
    # run to gigabytes); the values are those of cat-then-pad
    v = torch.empty(lead + (spec.padded,), dtype=torch.float32,
                    device=first.device)
    off = 0
    for k, sz in zip(spec.keys, spec.sizes):
        v[..., off:off + sz].copy_(tree[k].reshape(lead + (sz,)))
        off += sz
    v[..., spec.total:].zero_()
    return store_as(v.reshape(lead + (spec.rows, spec.cols)), dtype)


def unpack(flat: torch.Tensor, spec: FlatSpec) -> Dict[str, torch.Tensor]:
    """``(*lead, rows, cols)`` buffer -> parameter dict with the spec's
    shapes and dtypes.  For fp32 buffers the leaves are views of
    ``flat``."""
    lead = tuple(flat.shape[:-2])
    v = flat.reshape(lead + (-1,))
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for k, sz, shp, dt in zip(spec.keys, spec.sizes, spec.shapes,
                              spec.dtypes):
        out[k] = store_as(v[..., off:off + sz].reshape(lead + shp), dt)
        off += sz
    return out


def leaves_of(flat: torch.Tensor,
              spec: FlatSpec) -> Dict[str, torch.Tensor]:
    """`unpack`'s parameter dict of a ``(*lead, rows, cols)`` buffer, with
    every leaf stored in a dtype other than ``flat``'s a contiguous
    ``(*lead, *shape)`` tensor, cast from one contiguous run a client (a
    cast of a strided view is a slow kernel on the card); the other
    leaves are views of ``flat``, as `unpack` gives them."""
    lead = tuple(flat.shape[:-2])
    v = flat.reshape(lead + (-1,))
    runs = v.reshape(-1, spec.padded)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for k, sz, shp, dt in zip(spec.keys, spec.sizes, spec.shapes,
                              spec.dtypes):
        if dt == flat.dtype:
            out[k] = v[..., off:off + sz].reshape(lead + shp)
        else:
            out[k] = torch.empty(lead + shp, dtype=dt, device=flat.device)
            dst = out[k].view(-1, sz) if sz else None
            for c in range(runs.shape[0] if sz else 0):
                store_into(dst[c], runs[c, off:off + sz])
        off += sz
    return out


def repack(flat: torch.Tensor, from_spec: FlatSpec,
           to_spec: FlatSpec) -> torch.Tensor:
    """Re-lay a ``(*lead, rows, cols)`` buffer from one stream's geometry
    into another's: the same flattened coordinates, the pad tail zeroed
    again, the dtype kept.  Matching geometries return ``flat`` itself,
    not a copy."""
    if from_spec.total != to_spec.total:
        raise ValueError(f"repack between incompatible specs: total "
                         f"{from_spec.total} vs {to_spec.total}")
    if (from_spec.rows, from_spec.cols) == (to_spec.rows, to_spec.cols):
        return flat
    lead = tuple(flat.shape[:-2])
    v = flat.reshape(lead + (-1,))[..., :from_spec.total]
    return F.pad(v, (0, to_spec.padded - to_spec.total)).reshape(
        lead + (to_spec.rows, to_spec.cols))
