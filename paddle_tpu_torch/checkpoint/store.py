"""Durable on-disk checkpoint format: manifest + raw blobs + COMMIT marker
(the port's copy of paddle_tpu/checkpoint/store.py, the same layout and
the same write protocol, so that each package reads the other's stores).

    <ckpt>/
      blobs/<i>.bin    raw little-endian array bytes, one file per array
      manifest.json    format version, user meta, JSON-able extras, and per
                       array: blob file, dtype, shape, nbytes, sha256
      COMMIT           sha256 of manifest.json, written LAST, after every
                       blob and the manifest are fsync'd, so its presence
                       IS the durability guarantee

Write protocol (torn-write safe): blobs -> fsync each -> manifest ->
fsync -> fsync dir -> COMMIT -> fsync -> fsync dir. A crash at any point
before the COMMIT leaves a prefix that `is_complete` rejects and the
engine sweeps; a crash after leaves a fully verifiable checkpoint.

Verified read: a missing, short or bit-flipped blob, a manifest that does
not hash to the COMMIT content, or an unparseable manifest raises
`CheckpointCorruptError`, whose `.reason` says which invariant broke.

Arrays: numpy arrays, or CPU torch tensors. numpy has no bfloat16, and the
port does not use `ml_dtypes`: a bfloat16 tensor is written as its raw
2-byte words under dtype "bfloat16" (the name the reference's store
writes), and read back as a torch.bfloat16 tensor through
`torch.frombuffer`; the float8 types the same way. Every other dtype
reads back as a numpy array.

Fault hooks (resilience.chaos): `torn_write:K` (the K-th blob written in
this process writes half its bytes, then the process SIGKILLs itself)
and `bitflip_ckpt:K` (one bit of the K-th blob flipped after its
checksum is recorded).
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..resilience import chaos

__all__ = [
    "CheckpointCorruptError", "write_store", "read_store", "read_manifest",
    "read_array", "is_complete", "fsync_dir", "fsync_file",
]

FORMAT = "paddle-tpu-ckpt"
VERSION = 1
MANIFEST = "manifest.json"
COMMIT = "COMMIT"
BLOB_DIR = "blobs"

# dtypes numpy lacks, by the name the reference's store writes them under
TORCH_ONLY = {"bfloat16": torch.bfloat16,
              "float8_e4m3fn": torch.float8_e4m3fn,
              "float8_e5m2": torch.float8_e5m2}
_TORCH_ONLY_NAME = {v: k for k, v in TORCH_ONLY.items()}


class CheckpointCorruptError(Exception):
    """A checkpoint directory failed integrity verification.

    `reason` is one of: "missing" (no manifest), "incomplete" (no COMMIT
    marker — a torn write that never committed), "manifest" (COMMIT/hash
    mismatch or unparseable manifest), "blob_missing", "truncated",
    "checksum" (bit rot / torn blob)."""

    def __init__(self, path: str, reason: str, detail: str = ""):
        self.path = path
        self.reason = reason
        self.detail = detail
        super().__init__(
            f"corrupt checkpoint at {path!r} ({reason})"
            + (f": {detail}" if detail else ""))


def fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """Durably record directory entries (new files / renames) themselves."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sha256_bytes(data) -> str:
    return hashlib.sha256(data).hexdigest()


def _payload(arr) -> Tuple[str, list, memoryview]:
    """(dtype name, shape, C-order bytes) of a numpy array or a CPU torch
    tensor, the bytes as a memoryview (no copy of a contiguous array)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        if t.device.type != "cpu":
            raise ValueError("write_store takes host tensors (got one on %s)"
                             % t.device)
        name = _TORCH_ONLY_NAME.get(t.dtype)
        if name is not None:
            words = (t.contiguous().reshape(-1).view(torch.uint8).numpy()
                     if t.numel() else np.zeros(0, np.uint8))
            return name, list(t.shape), memoryview(words)
        arr = t.numpy()
    arr = np.asarray(arr)
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return str(arr.dtype), list(arr.shape), memoryview(flat)


def _from_bytes(data: bytearray, name: str, shape):
    """The array of a blob: numpy, or torch for the TORCH_ONLY dtypes."""
    tdtype = TORCH_ONLY.get(name)
    if tdtype is not None:
        if not len(data):
            return torch.empty(shape, dtype=tdtype)
        return torch.frombuffer(data, dtype=tdtype).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise CheckpointCorruptError("<manifest>", "manifest",
                                     f"unknown dtype {name!r}")
    return np.frombuffer(data, dtype=dtype).reshape(shape)


def _write_blob(path: str, data: memoryview) -> None:
    """One durable blob write, with the two chaos fault hooks."""
    torn = chaos.torn_write_blob()
    with open(path, "wb") as f:
        if torn:
            # a torn write: half the payload reaches the disk, then the
            # process dies as if the machine lost power mid-save
            f.write(data[: len(data) // 2])
            f.flush()
            os.fsync(f.fileno())
            os.kill(os.getpid(), 9)  # SIGKILL — no handlers, no cleanup
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    if chaos.bitflip_blob() and len(data):
        with open(path, "r+b") as f:
            first = f.read(1)
            f.seek(0)
            f.write(bytes([first[0] ^ 0x01]))
            f.flush()
            os.fsync(f.fileno())


def write_store(path: str, arrays: Dict[str, object],
                meta: Optional[dict] = None,
                extras: Optional[dict] = None) -> int:
    """Write a complete checkpoint store into directory `path` (which must
    not yet contain one — the engine writes into a tmp dir then commits by
    rename). `arrays` maps names to numpy arrays or CPU torch tensors.
    Returns total blob bytes written."""
    os.makedirs(os.path.join(path, BLOB_DIR), exist_ok=True)
    entries = {}
    total = 0
    for i, (name, arr) in enumerate(arrays.items()):
        dtype, shape, data = _payload(arr)
        fname = os.path.join(BLOB_DIR, f"{i}.bin")
        _write_blob(os.path.join(path, fname), data)
        entries[name] = {
            "file": fname,
            "dtype": dtype,
            "shape": shape,
            "nbytes": len(data),
            "sha256": _sha256_bytes(data),
        }
        total += len(data)
    manifest = {
        "format": FORMAT, "version": VERSION,
        "meta": dict(meta or {}), "extras": dict(extras or {}),
        "arrays": entries,
    }
    mbytes = json.dumps(manifest, indent=1, sort_keys=True).encode()
    mpath = os.path.join(path, MANIFEST)
    with open(mpath, "wb") as f:
        f.write(mbytes)
        f.flush()
        os.fsync(f.fileno())
    fsync_dir(os.path.join(path, BLOB_DIR))
    fsync_dir(path)
    # the commit point: everything above is durably on disk before this
    # marker exists, so COMMIT present == checkpoint verifiable
    with open(os.path.join(path, COMMIT), "w") as f:
        f.write(_sha256_bytes(mbytes) + "\n")
        f.flush()
        os.fsync(f.fileno())
    fsync_dir(path)
    return total


def is_complete(path: str) -> bool:
    return (os.path.isfile(os.path.join(path, COMMIT))
            and os.path.isfile(os.path.join(path, MANIFEST)))


def read_manifest(path: str, verify: bool = True) -> dict:
    mpath = os.path.join(path, MANIFEST)
    if not os.path.isfile(mpath):
        raise CheckpointCorruptError(path, "missing", "no manifest.json")
    if not os.path.isfile(os.path.join(path, COMMIT)):
        raise CheckpointCorruptError(path, "incomplete", "no COMMIT marker")
    with open(mpath, "rb") as f:
        mbytes = f.read()
    if verify:
        with open(os.path.join(path, COMMIT)) as f:
            want = f.read().strip()
        got = _sha256_bytes(mbytes)
        if got != want:
            raise CheckpointCorruptError(
                path, "manifest", f"manifest sha {got[:12]} != COMMIT "
                f"{want[:12]}")
    try:
        manifest = json.loads(mbytes)
    except ValueError as e:
        raise CheckpointCorruptError(path, "manifest", str(e))
    if manifest.get("format") != FORMAT:
        raise CheckpointCorruptError(
            path, "manifest", f"unknown format {manifest.get('format')!r}")
    return manifest


def _read_entry(path: str, name: str, ent: dict, verify: bool = True):
    """Verified read of one manifest entry's blob."""
    bpath = os.path.join(path, ent["file"])
    if not os.path.isfile(bpath):
        raise CheckpointCorruptError(path, "blob_missing",
                                     f"{name}: {ent['file']}")
    size = os.path.getsize(bpath)
    if size != int(ent["nbytes"]):
        raise CheckpointCorruptError(
            path, "truncated",
            f"{name}: {size} bytes on disk, manifest says "
            f"{ent['nbytes']}")
    data = bytearray(size)
    with open(bpath, "rb") as f:
        f.readinto(data)
    if verify and _sha256_bytes(data) != ent["sha256"]:
        raise CheckpointCorruptError(path, "checksum", name)
    return _from_bytes(data, ent["dtype"], ent["shape"])


def read_store(path: str, verify: bool = True
               ) -> Tuple[Dict[str, object], dict, dict]:
    """Verified load: returns (arrays, meta, extras) or raises
    CheckpointCorruptError on ANY integrity violation. Each array is a
    numpy array, or a torch tensor for a dtype numpy lacks."""
    manifest = read_manifest(path, verify=verify)
    arrays: Dict[str, object] = {}
    for name, ent in manifest.get("arrays", {}).items():
        arrays[name] = _read_entry(path, name, ent, verify=verify)
    return arrays, manifest.get("meta", {}), manifest.get("extras", {})


def read_array(path: str, name: str, verify: bool = True,
               manifest: Optional[dict] = None):
    """Verified read of ONE array from a store: only the named blob is
    resident, never the whole store. Pass `manifest` (from read_manifest)
    to amortize the manifest hash check over many per-array reads."""
    if manifest is None:
        manifest = read_manifest(path, verify=verify)
    ent = manifest.get("arrays", {}).get(name)
    if ent is None:
        raise CheckpointCorruptError(path, "blob_missing",
                                     f"{name}: not in manifest")
    return _read_entry(path, name, ent, verify=verify)
