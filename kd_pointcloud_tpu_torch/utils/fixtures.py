"""Fixture resolution: the port's copy of kd_pointcloud_tpu/utils/fixtures.py.

Expensive artifacts (parity fixtures, semitrained checkpoints) are
persisted in the checkout under evidence/fixtures/; a cache directory in
the temporary directory holds working copies:

    path = fixture_path("overfit.npz")   # cache copy, hydrated from
                                         # evidence/fixtures if needed

Resolution order: the evidence copy under its own name, then under its
alias (_ALIASES), then the legacy evidence/checkpoints store, each copied
into the cache when the cache's copy is missing or stale; else a
cache-only fixture; else None (the caller regenerates it and should then
persist_fixture it). numpy-free: the standard library only.
"""

from __future__ import annotations

import os
import os.path as osp
import shutil
import tempfile

CACHE_DIR = osp.join(tempfile.gettempdir(), "kdpc_train_parity")
_REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
EVIDENCE_DIR = osp.join(_REPO, "evidence", "fixtures")
# the legacy store (its semitrained_teacher.msgpack is the 6k-step
# checkpoint, a different regime than evidence/fixtures' 18k one)
CHECKPOINT_DIR = osp.join(_REPO, "evidence", "checkpoints")

# cache names whose evidence copy is committed under another file name:
# "semitrained_teacher.msgpack" is the 18k-step teacher; without the alias
# the resolver would fall through to CHECKPOINT_DIR's 6k-step checkpoint of
# the same name
_ALIASES = {"semitrained_teacher.msgpack": "semitrained_teacher_18k.msgpack"}


def _same_file(a: str, b: str) -> bool:
    sa, sb = os.stat(a), os.stat(b)
    # copy2 keeps mtime, so (size, mtime) stands for "this cache entry came
    # from that evidence copy"
    return sa.st_size == sb.st_size and int(sa.st_mtime) == int(sb.st_mtime)


def fixture_path(name: str, cache_dir: str | None = None) -> "str | None":
    """Path of fixture `name` in the cache, hydrated from the evidence copy
    when the cache is cold or stale (its (size, mtime) differs), so a stale
    cache never shadows a newer committed fixture. None if neither exists."""
    cache_dir = CACHE_DIR if cache_dir is None else cache_dir
    cached = osp.join(cache_dir, name)
    for src_dir, src_name in ((EVIDENCE_DIR, name),
                              (EVIDENCE_DIR, _ALIASES.get(name, name)),
                              (CHECKPOINT_DIR, name)):
        persisted = osp.join(src_dir, src_name)
        if osp.exists(persisted):
            if not (osp.exists(cached) and _same_file(cached, persisted)):
                os.makedirs(cache_dir, exist_ok=True)
                shutil.copy2(persisted, cached)
            return cached
    if osp.exists(cached):      # a cache-only fixture (never persisted)
        return cached
    return None


def persist_fixture(name: str, cache_dir: str | None = None) -> str:
    """Copy a (re)generated fixture from the cache into evidence/fixtures/;
    returns the evidence path."""
    cache_dir = CACHE_DIR if cache_dir is None else cache_dir
    os.makedirs(EVIDENCE_DIR, exist_ok=True)
    dst = osp.join(EVIDENCE_DIR, name)
    shutil.copy2(osp.join(cache_dir, name), dst)
    return dst
