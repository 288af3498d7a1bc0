"""Durable checkpoint save and load, format v2 (counterpart of
`bigdl_tpu/serialization/checkpoint.py`, whose files it reads and
writes).

A checkpoint is a directory of three pickled trees and a JSON manifest:

- `params.pkl`: the parameters in the JAX package's tree layout (nested
  dicts of numpy arrays, conv kernels HWIO), as
  `interop.jax_params.params_tree` gives them;
- `state.pkl`: the BN running stats, {module-path tuple: {"mean", "var"}}
  (`interop.jax_params.module_state`);
- `optim.pkl`: {"class", "state" (epoch, neval, ...), "hyper" (the
  method's scalar settings), "slots" (the optimizer's slot tree in the
  parameters' tree layout), "cursor" (the data cursor)};
- `manifest.json`: format, model name, time, tag, and a sha256 digest and
  size for each file.

Everything is host numpy (a CUDA or bf16 tensor is stored as an f32
numpy array), so a checkpoint the reference wrote loads here and one
written here loads into the reference.

Durability, as the reference's:

- atomic: files are written into a hidden `.tmp-*` staging directory,
  renamed into place after the manifest lands; a crash at any point
  leaves the previous checkpoints intact. Re-saving a tag moves the old
  directory aside and restores it if the publish fails;
- verified: `load_checkpoint` re-hashes every file as it reads and raises
  `CheckpointCorruptError` on a mismatch or an undecodable file;
- recoverable: `load_latest_valid` walks checkpoints newest first,
  quarantines a proven-corrupt one (a hidden `.corrupt-*` directory) and
  returns the newest good one;
- bounded: `keep_last_n` prunes the oldest valid checkpoints after a save.

In a data-parallel run every rank calls `save_on_rank0`: rank 0 writes,
between a barrier and an all-reduced success flag, so the checkpoint is
there for every rank when the call returns, and a failed write fails
every rank at the same step. Under tensor parallelism every rank first
gathers the whole parameters and slots (its `gather` argument), so rank 0
writes whole arrays that the reference loads.

Paths may be local or `memory://` (`utils/filesystem.py`). The `ckpt.*`
fault sites sit between the writes. Sharded checkpoints
(`sharded_checkpoint.py`, through `torch.distributed.checkpoint`) are
found, loaded and pruned by the same scan: their manifests say
`"sharded": true`.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from bigdl_tpu_torch.parallel import collectives
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.utils import filesystem as fsys

logger = logging.getLogger("bigdl_tpu_torch.serialization")

FORMAT_V2 = "bigdl_tpu.checkpoint.v2"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed digest verification or could not be decoded."""


def _tag_sort_key(tag: str):
    """Natural sort key (iter9 < iter25): the tie-break between manifests
    of equal times."""
    return tuple(int(p) if p.isdigit() else p
                 for p in re.split(r"(\d+)", str(tag)))


def _host(tree):
    """A tree with every tensor leaf as a host numpy array (bf16 widened
    to f32: numpy has no bf16); dicts, lists and tuples keep their shape,
    other leaves stay as they are."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


class _Sha256Tee:
    """Feeds sha256 and a byte count as pickle streams through, so the
    payload is never held as one blob."""

    def __init__(self, f):
        self._f = f
        self.sha = hashlib.sha256()
        self.nbytes = 0

    def write(self, b):
        self.sha.update(b)
        self.nbytes += len(b)
        return self._f.write(b)


class _Sha256Reader:
    """The read-side twin of `_Sha256Tee`."""

    def __init__(self, f):
        self._f = f
        self.sha = hashlib.sha256()

    def read(self, n=-1):
        b = self._f.read(n)
        self.sha.update(b)
        return b

    def readline(self, n=-1):
        b = self._f.readline(n)
        self.sha.update(b)
        return b


_HASH_CHUNK = 1 << 20


def _check_digest(ckpt_dir: str, fname: str, got: str, want: str) -> None:
    if got != want:
        raise CheckpointCorruptError(
            f"digest mismatch for {fname} in {ckpt_dir}: "
            f"manifest {want[:12]}…, file {got[:12]}…")


def _dump_pickle(path: str, payload) -> Dict:
    with fsys.open_file(path, "wb") as f:
        tee = _Sha256Tee(f)
        pickle.dump(payload, tee, protocol=pickle.DEFAULT_PROTOCOL)
    return {"sha256": tee.sha.hexdigest(), "bytes": tee.nbytes}


def save_checkpoint(path: str, model, params, model_state, optim_method,
                    opt_slots=None, tag: str = "", overwrite: bool = True,
                    keep_last_n: Optional[int] = None,
                    cursor: Optional[Dict] = None) -> str:
    """Write <path>/<tag or timestamp>/ with params.pkl, state.pkl,
    optim.pkl and manifest.json, staged in a hidden directory and renamed
    into place. `params`, `model_state` and `opt_slots` are trees in the
    reference's layout (the optimizers build them through
    `interop.jax_params`); tensor leaves are stored as numpy. `cursor` is
    the dataset's `cursor()`. `keep_last_n` prunes the oldest valid
    checkpoints after the save commits. Returns the checkpoint
    directory."""
    if keep_last_n is not None and keep_last_n < 1:
        raise ValueError(f"keep_last_n must be >= 1, got {keep_last_n}")
    name = tag or time.strftime("%Y%m%d_%H%M%S")
    ckpt_dir = fsys.join(path, name)
    if fsys.exists(ckpt_dir) and not overwrite:
        raise FileExistsError(ckpt_dir)
    tmp_dir = fsys.join(path, f".tmp-{name}-{os.getpid()}")
    fsys.makedirs(tmp_dir, exist_ok=True)
    displaced = None
    try:
        optim_blob = {
            "class": type(optim_method).__name__,
            "state": dict(optim_method.state),
            "hyper": {k: v for k, v in vars(optim_method).items()
                      if isinstance(v, (int, float, bool, str))},
            "slots": _host(opt_slots) if opt_slots is not None else None,
            "cursor": cursor,
        }
        files: Dict[str, Dict] = {}
        for fname, site, payload in (
                ("params.pkl", "ckpt.write.params", _host(params)),
                ("state.pkl", "ckpt.write.state",
                 {k: _host(v) for k, v in (model_state or {}).items()}),
                ("optim.pkl", "ckpt.write.optim", optim_blob)):
            faults.fire(site, path=ckpt_dir, file=fname)
            files[fname] = _dump_pickle(fsys.join(tmp_dir, fname),
                                        payload)
        manifest = {
            "format": FORMAT_V2,
            "model": getattr(model, "name", "model"),
            "time": time.time(),
            "tag": name,
            "files": files,
        }
        faults.fire("ckpt.write.manifest", path=ckpt_dir)
        with fsys.open_file(fsys.join(tmp_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        # commit: the rename publishes. An existing same-tag directory is
        # moved aside first, so a failed publish can put it back
        faults.fire("ckpt.commit", path=ckpt_dir)
        if fsys.exists(ckpt_dir):
            displaced = fsys.join(path, f".replaced-{name}-{os.getpid()}")
            fsys.rename(ckpt_dir, displaced)
        fsys.rename(tmp_dir, ckpt_dir)
        if displaced is not None:
            try:
                fsys.rmtree(displaced)
            except Exception as e:
                logger.warning("could not remove displaced checkpoint %s "
                               "(%r)", displaced, e)
    except BaseException:
        try:
            if displaced is not None and not fsys.exists(ckpt_dir):
                fsys.rename(displaced, ckpt_dir)
        except Exception:
            pass
        try:
            fsys.rmtree(tmp_dir)
        except Exception:
            pass
        raise
    if keep_last_n is not None:
        prune_checkpoints(path, keep_last_n)
    return ckpt_dir


def save_on_rank0(save: Callable[..., Any], device,
                  gather: Optional[Callable[[], Any]] = None
                  ) -> Optional[Any]:
    """`save()` (a checkpoint write) on rank 0 of the process group,
    called by every rank: a barrier, rank 0's write, then a success flag
    all-reduced on `device`. With `gather`, every rank first calls
    `gather()` (collectives that every rank must join: the whole
    tensor-parallel parameters) and rank 0 writes `save(gathered)`.
    Returns what `save` returned on rank 0, None on the others. A failed
    write re-raises on rank 0 and raises `OSError` on the others, all at
    the same step. At world size 1 it is `save()`."""
    args = () if gather is None else (gather(),)
    if collectives.world_size() == 1:
        return save(*args)
    collectives.barrier()
    out, failed = None, None
    if collectives.rank() == 0:
        try:
            out = save(*args)
        except Exception as e:
            failed = e
    flag = torch.tensor([0.0 if failed is None else 1.0], device=device)
    collectives.all_reduce_(flag, "flag")
    if failed is not None:
        raise failed
    if float(flag) > 0:
        raise OSError("rank 0 failed to write the checkpoint")
    return out


def _read_manifest(mf_path: str) -> Optional[Dict]:
    """One manifest, or None (with a warning) when it is missing or
    unreadable: its checkpoint is then no candidate."""
    try:
        with fsys.open_file(mf_path, "r") as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except Exception as e:
        logger.warning("skipping checkpoint with unreadable manifest %s "
                       "(%r)", mf_path, e)
        return None


def _scan_checkpoints(path: str) -> List[Tuple[str, Dict]]:
    """(dir, manifest) pairs under `path`, newest first."""
    if not fsys.isdir(path):
        return []
    found = []
    for d in fsys.listdir(path):
        if d.startswith("."):
            continue
        manifest = _read_manifest(fsys.join(path, d, "manifest.json"))
        if manifest is None:
            continue
        t = manifest.get("time", 0) or 0
        found.append((float(t), _tag_sort_key(manifest.get("tag", d)),
                      fsys.join(path, d), manifest))
    found.sort(key=lambda e: e[:2], reverse=True)
    return [(p, m) for _, _, p, m in found]


def valid_checkpoints(path: str) -> List[str]:
    """Checkpoint dirs under `path` with a readable manifest, newest first
    (manifest time, then natural tag order). Hidden entries (staging and
    quarantine dirs) are never candidates."""
    return [p for p, _ in _scan_checkpoints(path)]


def latest_checkpoint(path: str) -> Optional[str]:
    """The newest checkpoint dir under `path`."""
    cks = valid_checkpoints(path)
    return cks[0] if cks else None


def verify_checkpoint(ckpt_dir: str) -> Dict:
    """Re-hash every file the manifest lists; returns the manifest.
    Raises `CheckpointCorruptError` on a missing or unreadable manifest or
    file, or a digest mismatch. v1 manifests (no digests) pass."""
    manifest = _read_manifest(fsys.join(ckpt_dir, "manifest.json"))
    if manifest is None:
        raise CheckpointCorruptError(
            f"missing or unreadable manifest in {ckpt_dir}")
    for fname, meta in (manifest.get("files") or {}).items():
        want = meta.get("sha256")
        if not want:
            continue
        h = hashlib.sha256()
        try:
            with fsys.open_file(fsys.join(ckpt_dir, fname), "rb") as f:
                for chunk in iter(lambda: f.read(_HASH_CHUNK), b""):
                    h.update(chunk)
        except Exception as e:
            raise CheckpointCorruptError(
                f"checkpoint file {fname} unreadable in {ckpt_dir}: "
                f"{e!r}") from e
        _check_digest(ckpt_dir, fname, h.hexdigest(), want)
    return manifest


def load_checkpoint(ckpt_dir: str, verify: bool = True,
                    manifest: Optional[Dict] = None) \
        -> Tuple[Any, Dict, Dict]:
    """(params, model_state, optim_blob) of a checkpoint, as numpy trees.
    With `verify`, each file is hashed as it streams through the
    unpickler and checked against the manifest: corruption raises
    `CheckpointCorruptError`. A failing read (OSError) is not proven
    corruption and raises as it is."""
    if manifest is None:
        manifest = _read_manifest(fsys.join(ckpt_dir, "manifest.json"))
    files = (manifest or {}).get("files") or {}

    def read(fname):
        meta = files.get(fname)
        want = meta.get("sha256") if (verify and meta) else None
        with fsys.open_file(fsys.join(ckpt_dir, fname), "rb") as f:
            src = _Sha256Reader(f) if want else f
            try:
                payload = pickle.load(src)
            except OSError:
                raise
            except Exception as e:
                raise CheckpointCorruptError(
                    f"cannot decode {fname} in {ckpt_dir}: {e!r}") from e
            if want:
                # the digest covers bytes past the pickle's end too
                for chunk in iter(lambda: f.read(_HASH_CHUNK), b""):
                    src.sha.update(chunk)
                _check_digest(ckpt_dir, fname, src.sha.hexdigest(), want)
        return payload

    return read("params.pkl"), read("state.pkl"), read("optim.pkl")


def quarantine_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Rename a bad checkpoint to a hidden `.corrupt-<tag>` sibling, out of
    the resume scan. Returns the new path, or None if the rename
    failed."""
    s = str(ckpt_dir).rstrip("/")
    if fsys.is_uri(s):
        parent, name = s.rsplit("/", 1)
    else:
        parent, name = os.path.dirname(s), os.path.basename(s)
    base = fsys.join(parent, f".corrupt-{name}")
    dest = base
    n = 1
    while fsys.exists(dest):
        n += 1
        dest = f"{base}-{n}"
    try:
        fsys.rename(ckpt_dir, dest)
        return dest
    except Exception as e:
        logger.warning("could not quarantine corrupt checkpoint %s (%r)",
                       ckpt_dir, e)
        return None


def load_latest_valid(path: str, quarantine: bool = True, telemetry=None):
    """The resume entry point: `(ckpt_dir, params, model_state,
    optim_blob)` of the newest checkpoint under `path` that verifies and
    decodes, or None; a sharded one (`sharded_checkpoint.py`) loads whole,
    as the reference's does. A proven-corrupt one
    (`CheckpointCorruptError`) is quarantined and the walk goes on to the
    next older one; any other failure (a read error) also goes on but
    leaves it in place. `telemetry`, if given, gets `checkpoint_quarantined`,
    `checkpoint_unreadable` and `checkpoint_verified` events. Under a
    process group every rank calls it, and the ranks agree on each
    checkpoint's outcome: they walk rank 0's list of candidates, and one
    that fails on any rank (`collectives.any_failed`; the sharded load
    agrees inside) is passed over by all, so they load the same one; only
    rank 0 quarantines."""
    grouped = collectives.world_size() > 1
    candidates = _scan_checkpoints(path) if collectives.rank() == 0 \
        else None
    for ckpt, manifest in collectives.broadcast_object(candidates):
        sharded = manifest.get("sharded")
        failed = None
        try:
            if sharded:
                from bigdl_tpu_torch.serialization.sharded_checkpoint \
                    import load_checkpoint_sharded
                params, mstate, oblob = load_checkpoint_sharded(ckpt)
            else:
                params, mstate, oblob = load_checkpoint(
                    ckpt, verify=True, manifest=manifest)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            failed = e
        if grouped and not sharded and \
                collectives.any_failed(failed is not None):
            failed = failed or OSError(
                f"checkpoint {ckpt} failed to load on another rank")
        if failed is not None:
            corrupt = isinstance(failed, CheckpointCorruptError)
            logger.warning("checkpoint %s failed to load (%r); falling "
                           "back to the next older one%s", ckpt, failed,
                           "" if corrupt else " (left in place: the "
                           "failure is not proven corruption)")
            _event(telemetry, "checkpoint_quarantined" if corrupt
                   else "checkpoint_unreadable", path=str(ckpt),
                   error=repr(failed))
            if quarantine and corrupt and collectives.rank() == 0:
                quarantine_checkpoint(ckpt)
            continue
        _event(telemetry, "checkpoint_verified", path=str(ckpt),
               format=manifest.get("format", "v1"), tag=manifest.get("tag"))
        return ckpt, params, mstate, oblob
    return None


def _event(telemetry, kind: str, **fields):
    if telemetry is None:
        return
    try:
        telemetry.event(kind, **fields)
    except Exception:
        logger.exception("telemetry emit of %s failed", kind)


def prune_checkpoints(path: str, keep_last_n: int) -> List[str]:
    """Delete all but the newest `keep_last_n` valid checkpoints under
    `path`; returns the removed dirs. Failures are logged, never raised."""
    if keep_last_n < 1:
        raise ValueError(f"keep_last_n must be >= 1, got {keep_last_n}")
    removed = []
    try:
        victims = valid_checkpoints(path)[keep_last_n:]
    except Exception as e:
        logger.warning("retention scan of %s failed (%r); prune skipped",
                       path, e)
        return removed
    for victim in victims:
        try:
            fsys.rmtree(victim)
            removed.append(victim)
        except Exception as e:
            logger.warning("retention could not remove %s (%r)", victim, e)
    return removed


def restore_optim_method(optim_method, optim_blob: Dict):
    """Apply a saved optim blob to an optimization method: the counters
    (epoch, neval, ...) and every scalar setting `hyper` names that the
    method has (the port's methods carry the reference's attribute
    names)."""
    optim_method.state.update(optim_blob.get("state", {}))
    for k, v in optim_blob.get("hyper", {}).items():
        if hasattr(optim_method, k):
            setattr(optim_method, k, v)
    return optim_method

