"""Storage initializer — pulls a model into the pod's model dir; own copy
of ``kubeflow_tpu/serving/storage.py``.

The kserve storage initializer runs as an initContainer and materializes
gs://, s3://, pvc://, hf://, file:// URIs under /mnt/models.

Remote schemes (gs/s3/hf/http) go through an ObjectStore provider:
  - No real object-store client ships with the package: without an
    emulator the default provider raises a clear gated error (the JAX
    package's message) rather than a stubbed-but-broken download.
  - Setting KFTPU_OBJECT_STORE_EMULATOR=<dir> swaps in a file-backed
    emulator with real object-store semantics — bucket/key-prefix listing,
    per-object fetch, atomic materialization, and a (size, mtime) pull
    cache — so every remote-scheme code path (layout, caching, error
    handling) runs and is tested without egress. Emulator layout:
    <root>/<scheme>/<bucket>/<key...> (e.g. <root>/gs/my-bucket/model/...).

pvc:// resolves under a configurable local volume root (the PVC mount
analogue); file:// and bare paths copy from the local filesystem.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from dataclasses import dataclass
from pathlib import Path
from urllib.parse import urlparse

from kubeflow_tpu_torch.utils.envvars import (
    ENV_OBJECT_STORE_EMULATOR,
    ENV_PVC_ROOT,
)

# PVC mount root: pvc://volume-name/sub/path -> $KFTPU_PVC_ROOT/volume-name/sub/path
PVC_ROOT_ENV = ENV_PVC_ROOT
DEFAULT_PVC_ROOT = ".kubeflow_tpu/volumes"

# local tree emulating gs://, s3://, hf://, http(s):// object stores
EMULATOR_ENV = ENV_OBJECT_STORE_EMULATOR

_REMOTE_SCHEMES = ("gs", "s3", "hf", "http", "https")
# per-destination pull cache: object key -> (size, mtime) of the fetched copy
MANIFEST_FILE = ".kft_pull_manifest.json"


@dataclass(frozen=True)
class ObjectInfo:
    key: str      # full key within the bucket
    size: int
    mtime: float


class ObjectStore:
    """Minimal object-store surface the initializer needs: prefix listing
    and per-object fetch. Real GCS/S3/HF clients implement the same two
    calls; this environment ships the file-backed emulator only."""

    def list(self, bucket: str, prefix: str) -> list[ObjectInfo]:
        raise NotImplementedError

    def fetch(self, bucket: str, key: str, dest: Path) -> None:
        raise NotImplementedError


class EmulatedObjectStore(ObjectStore):
    """File-backed emulator: <root>/<scheme>/<bucket>/<key...>."""

    def __init__(self, scheme: str, root: Path):
        self.root = Path(root) / scheme

    def _base(self, bucket: str) -> Path:
        # bucket names are single path components; '..', '/', '' would walk
        # out of the emulator tree (the uri is client-controllable via the
        # repository load API)
        if not bucket or "/" in bucket or bucket in (".", ".."):
            raise ValueError(f"invalid bucket name {bucket!r}")
        return self.root / bucket

    def list(self, bucket: str, prefix: str) -> list[ObjectInfo]:
        base = self._base(bucket)
        if not base.is_dir():
            return []
        prefix = prefix.strip("/")
        if ".." in prefix.split("/"):
            raise ValueError(f"invalid key prefix {prefix!r}")
        # walk only the prefix subtree (or the single object), not the
        # whole bucket — listing cost tracks the model, not the store
        start = base / prefix if prefix else base
        if start.is_file():
            candidates = [start]
        elif start.is_dir():
            candidates = sorted(p for p in start.rglob("*") if p.is_file())
        else:
            return []
        out = []
        for p in candidates:
            if p.name == MANIFEST_FILE:
                continue
            key = p.relative_to(base).as_posix()
            st = p.stat()
            out.append(ObjectInfo(key, st.st_size, st.st_mtime))
        return out

    def fetch(self, bucket: str, key: str, dest: Path) -> None:
        src = self._base(bucket) / key
        dest.parent.mkdir(parents=True, exist_ok=True)
        tmp = dest.with_name(dest.name + ".part")
        shutil.copy2(src, tmp)
        tmp.replace(dest)  # atomic: a crashed pull never leaves half files


def _provider_for(scheme: str) -> ObjectStore:
    root = os.environ.get(EMULATOR_ENV)
    if root:
        return EmulatedObjectStore(scheme, Path(root))
    raise RuntimeError(
        f"storage scheme '{scheme}://' needs network egress, which this "
        f"environment does not have; stage the model locally and use "
        f"file:// or pvc:// instead, or point {EMULATOR_ENV} at a "
        f"file-backed emulator tree"
    )


def _split_remote(uri: str) -> tuple[str, str]:
    """'gs://bucket/a/b' -> ('bucket', 'a/b'); hf://org/model keeps the org
    as the bucket; http(s) uses the host."""
    parsed = urlparse(uri)
    return parsed.netloc, parsed.path.strip("/")


def _pull_remote(uri: str, scheme: str, dest: Path) -> Path:
    bucket, prefix = _split_remote(uri)
    if not bucket:
        raise ValueError(f"storage uri {uri!r}: missing bucket/host")
    store = _provider_for(scheme)
    # enforce the key/prefix "directory" boundary HERE, not per-provider:
    # real S3/GCS listings are plain string-prefix matches, so a provider
    # that faithfully mirrors them would otherwise leak 'model2/x' into a
    # pull of 'model'
    objs = [
        o for o in store.list(bucket, prefix)
        if not prefix or o.key == prefix or o.key.startswith(prefix + "/")
    ]
    if not objs:
        raise FileNotFoundError(
            f"storage uri {uri!r}: no objects under bucket {bucket!r} "
            f"prefix {prefix!r}"
        )
    manifest_path = dest / MANIFEST_FILE
    if dest.exists() and not manifest_path.exists():
        # dest was materialized by something other than a remote pull (a
        # local-scheme copy, a stale model): REPLACE, per the idempotence
        # contract — merging would serve mixed model files
        shutil.rmtree(dest)
    dest.mkdir(parents=True, exist_ok=True)
    try:
        manifest = json.loads(manifest_path.read_text())
        if not isinstance(manifest, dict):
            raise ValueError(f"manifest is {type(manifest).__name__}")
        # the cache is only valid for the SAME source: two versions of a
        # model can share sizes+mtimes (cp -p publishing), so a uri switch
        # must refetch everything
        cache = manifest["objects"] if manifest.get("uri") == uri else {}
        if not isinstance(cache, dict):
            cache = {}
    except (OSError, ValueError, TypeError, KeyError):
        cache = {}
    new_cache = {}
    for obj in objs:
        # dest-relative name: strip the shared prefix "directory"
        rel = obj.key
        if prefix and rel == prefix:
            rel = Path(obj.key).name  # single-object uri
        elif prefix:
            rel = obj.key[len(prefix) + 1:]
        entry = [obj.size, obj.mtime]
        target = dest / rel
        if cache.get(rel) == entry and target.exists():
            new_cache[rel] = entry  # unchanged: skip the fetch
            continue
        store.fetch(bucket, obj.key, target)
        new_cache[rel] = entry
    # drop whatever the source does not have NOW — diffed against the dest
    # tree itself, not the previous manifest, so cleanup survives a lost or
    # corrupted manifest
    for p in list(dest.rglob("*")):
        if not p.is_file() or p.name == MANIFEST_FILE:
            continue
        if p.relative_to(dest).as_posix() not in new_cache:
            p.unlink()
    tmp = manifest_path.with_name(manifest_path.name + ".tmp")
    tmp.write_text(json.dumps({"uri": uri, "objects": new_cache}))
    tmp.replace(manifest_path)  # atomic: no torn manifest on crash
    return dest


def _normalize(storage_uri: str) -> tuple[str, str]:
    """One place deciding remote-vs-local: (stripped uri, scheme or '')."""
    uri = storage_uri.strip()
    scheme = urlparse(uri).scheme
    return uri, (scheme if scheme in _REMOTE_SCHEMES else "")


def resolve_uri(storage_uri: str) -> Path:
    """Map a LOCAL storage URI to a source path (no copy). Remote schemes
    have no local source path; pull_model handles them via providers."""
    uri, scheme = _normalize(storage_uri)
    if scheme:
        raise RuntimeError(
            f"storage scheme {scheme + '://'!r} has no local path; use "
            f"pull_model to materialize it"
        )
    if uri.startswith("pvc://"):
        root = Path(os.environ.get(PVC_ROOT_ENV, DEFAULT_PVC_ROOT))
        return root / uri[len("pvc://"):]
    if uri.startswith("file://"):
        return Path(uri[len("file://"):])
    return Path(uri)


# Per-destination locks: the repository API serves concurrent load requests
# from ThreadingHTTPServer threads; two pulls racing into one dest would
# cross rmtree/fetch and tear the tree. In-process is sufficient — replicas
# are separate processes with per-replica dest dirs.
_PULL_LOCKS: dict[str, threading.Lock] = {}
_PULL_LOCKS_GUARD = threading.Lock()


def _dest_lock(dest: Path):
    key = str(Path(dest).resolve())
    with _PULL_LOCKS_GUARD:
        lock = _PULL_LOCKS.get(key)
        if lock is None:
            lock = _PULL_LOCKS[key] = threading.Lock()
    return lock


def pull_model(storage_uri: str, dest_dir: str | Path) -> Path:
    """Materialize the model under dest_dir (the /mnt/models contract).
    Returns the destination path. Idempotent: re-pull replaces (local
    schemes) or incrementally syncs via the pull cache (remote schemes).
    Serialized per destination — concurrent loads of the same model are
    safe."""
    with _dest_lock(Path(dest_dir)):
        return _pull_model_locked(storage_uri, dest_dir)


def _pull_model_locked(storage_uri: str, dest_dir: str | Path) -> Path:
    uri, scheme = _normalize(storage_uri)
    if scheme:
        return _pull_remote(uri, scheme, Path(dest_dir))
    src = resolve_uri(uri)
    if not src.exists():
        raise FileNotFoundError(f"storage uri {storage_uri!r} -> {src} not found")
    dest = Path(dest_dir)
    if dest.exists():
        shutil.rmtree(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    if src.is_dir():
        shutil.copytree(src, dest)
    else:
        dest.mkdir(parents=True, exist_ok=True)
        shutil.copy2(src, dest / src.name)
    return dest
